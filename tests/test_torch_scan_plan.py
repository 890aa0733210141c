"""The host side and the arithmetic of K3, K4 and K8 (the StyleNet, NIC
and SentiCap training scans: ``csrc/lstm_scan.cu``, ``csrc/nic_scan.cu``,
``csrc/senticap_scan.cu``, their recurrence in ``csrc/scan_grid.cuh``)
that the CPU can check, without JAX:

- the recurrence's launch plan (``ops/scan_grid.py::scan_plan``) at the
  main path's shapes (K3 and K4: B 64, H 512; K8: B 128, H 512) and at edge
  shapes (B 1 to 2048; H 8 to 2048, past the resident plan's reach: the
  streamed kind): every (row, unit) of the forward and every (row, unit,
  k) of the backward's product owned by one block, shared memory within a
  block's 227 KB as the kernels lay it out, at most one block an SM, the
  choice at the main shapes, every resident-only plan unchanged,
  a plan for every B and H up to 2048 on 132 and 114 SMs, and the
  refusal of a shape past that reach, naming the kernel;
- the ctypes mirror of the source's ``ScanPlan``, the geometry constants
  and the C entry points' argument counts, held against the sources' text;
- the kernels' arithmetic in tensor ops (``scan_grid.*_tc_plain``: every
  product 3xTF32 through ``att_scan.tf32x3_product_plain``, the backward's
  recurrent dh as the plan's k ranges added in range order, then clamped)
  over T = 25 steps at small width and at H = 768 and 1024 (streamed
  plans), against the unchanged plain scans and float64 within phases 7
  and 12's tolerances (h and c atol 1e-4, each gradient within 1e-3 of its
  largest magnitude), and where B is a multiple of 8 against the JAX
  package's Pallas kernels in interpret mode (``jax.vjp`` for the grads) at
  the same tolerances; K8 at gclip 5.0 and at 0.01, where the clamp binds,
  K4 with H not a multiple of 32.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import hashlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icee_tpu.ops.pallas_lstm import fused_factored_scan as jax_k3
from icee_tpu.ops.pallas_nic_train import fused_nic_scan as jax_k4
from icee_tpu.ops.pallas_senticap_train import fused_senticap_scan as jax_k8

from icee_tpu_torch.ops import cuda_lib, lstm_scan, nic_scan, scan_grid
from icee_tpu_torch.ops import senticap_scan as ss

CSRC = Path(scan_grid.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "scan_grid.cuh").read_text()

EDGE = [(b, h) for b in (1, 3, 64, 128, 200, 512, 2048)
        for h in (8, 33, 300, 512, 704, 736, 1024, 2048)]


def _owners_fwd(plan):
    own = np.zeros((plan.B, plan.H), dtype=np.int8)
    for q in range(plan.f_blocks):
        for rows, units in plan.fwd_items(q):
            own[rows.start:rows.stop, units.start:units.stop] += 1
    return own


def _owners_bwd(plan):
    """Owners of the backward product's (64-row pass, unit, 32-deep k
    tile): every item's rows and k range start on those boundaries."""
    own = np.zeros((-(-plan.B // 64), plan.H, -(-4 * plan.H // 32)),
                   dtype=np.int8)
    for q in range(plan.b_blocks):
        for rows, units, ks in plan.bwd_items(q):
            assert rows.start % 64 == 0 and ks.start % 32 == 0
            assert rows.stop == plan.B or rows.stop % 64 == 0
            assert ks.stop == 4 * plan.H or ks.stop % 32 == 0
            own[rows.start // 64:-(-rows.stop // 64),
                units.start:units.stop,
                ks.start // 32:-(-ks.stop // 32)] += 1
    return own


@pytest.mark.parametrize("b,h", EDGE)
def test_every_unit_row_and_k_is_owned_once(b, h):
    plan = scan_grid.scan_plan("K", b, h)
    assert (_owners_fwd(plan) == 1).all()
    assert (_owners_bwd(plan) == 1).all()
    # the backward's gate pass: every (b, j) element in one block's range
    gates = np.zeros(b * h, dtype=np.int8)
    for q in range(plan.b_blocks):
        els = plan.gate_block(q)
        assert len(els) <= plan.b_per
        gates[els.start:els.stop] += 1
    assert (gates == 1).all()
    # no block is empty: the plan launches no idle block
    for q in range(plan.f_blocks):
        assert plan.fwd_items(q)
        for rows, units in plan.fwd_items(q):
            assert len(rows) and len(units)
    for q in range(plan.b_blocks):
        assert plan.bwd_items(q)
        for rows, units, ks in plan.bwd_items(q):
            assert len(rows) and len(units) and len(ks)


@pytest.mark.parametrize("b,h", EDGE)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_blocks_fit_the_card_one_an_sm(b, h, sms):
    plan = scan_grid.scan_plan("K", b, h, sms)
    assert 1 <= plan.f_blocks <= sms and 1 <= plan.b_blocks <= sms
    assert plan.f_smem <= scan_grid.SG_SMEM_LIMIT == cuda_lib.SMEM_LIMIT
    assert plan.b_smem <= scan_grid.SG_SMEM_LIMIT
    # shared memory as the kernels lay it out.  Resident: the slice's hi
    # and lo words, the A ring, the forward's out and c tiles, the
    # backward's out tile and gate-pass tiles (8 words an element).
    # Streamed: 1024 bytes to align the ring, each stage B's hi and lo
    # tiles and an A tile, the out tile.
    kd = min(plan.b_kc, -(-4 * h // 32) * 32)
    nc, u = 4 * plan.f_units, plan.f_units
    tile = 4 * 64 * 36
    if plan.b_kind == scan_grid.RESIDENT:
        assert plan.b_smem == (2 * 4 * plan.b_units * kd + 1024
                               + 4 * 64 * (plan.b_units + 1)
                               + 32 * plan.b_per + plan.b_stages * tile)
        assert plan.b_blocks == math.ceil(h / plan.b_units) * plan.b_splits
    else:
        # an item: mt M tiles of 64 rows sharing each tile of the planes
        assert plan.b_kind == scan_grid.STREAMED
        mt = plan.b_rows // 64
        assert plan.b_rows == 64 * mt and mt in (1, 2)
        assert plan.b_smem == (1024 + 4 * 64 * mt * (plan.b_units + 1)
                               + plan.b_stages * (256 * plan.b_units
                                                  + mt * tile))
        items = (math.ceil(b / plan.b_rows) * math.ceil(h / plan.b_units)
                 * plan.b_splits)
        assert plan.b_blocks == min(items, sms)
        assert plan.b_kc % 32 == 0
    if plan.f_kind == scan_grid.RESIDENT:
        assert plan.f_smem == (2 * 4 * nc * (-(-h // 32) * 32) + 1024
                               + 4 * (64 * (nc + 1) + plan.f_rows * u)
                               + plan.f_stages * tile)
    else:
        assert plan.f_kind == scan_grid.STREAMED
        mt = plan.f_rows // 64
        assert plan.f_rows == 64 * mt and mt in (1, 2)
        assert plan.f_smem == (1024 + 4 * 64 * mt * (nc + 1)
                               + plan.f_stages * (256 * nc + mt * tile))
        assert plan.f_blocks == min(
            math.ceil(b / plan.f_rows) * math.ceil(h / u), sms)
    # every tile of a pass in flight where shared memory allows
    assert 2 <= plan.f_stages <= min(-(-h // 32) + 1, 9)
    assert 2 <= plan.b_stages <= min(kd // 32 + 1, 9)
    assert plan.b_per % 4 == 0 and plan.b_per * plan.b_blocks >= b * h
    assert plan.f_rows % scan_grid.SG_ROWS == 0
    # wgmma's N: all of a block's columns
    assert 4 * plan.f_units in (16, 32, 64)
    assert plan.b_units in (16, 32, 64)
    assert plan.b_splits == math.ceil(4 * h / plan.b_kc)


# The plans of the resident-only search (before the streamed kind) over
# the old edge shapes, the main shapes and H = 704, on 132, 114 and 16 SMs:
# (B, H, SMs) -> (f_rows, f_units, f_blocks, f_stages, b_units, b_kc,
# b_splits, b_blocks, b_stages, b_per, f_smem, b_smem).  Shapes it refused
# are not listed.
RESIDENT_PLANS = {
    (1, 8, 132): (64, 4, 2, 2, 16, 32, 1, 1, 2, 8, 28928, 28160),
    (1, 33, 132): (64, 4, 9, 3, 16, 32, 5, 15, 2, 4, 42240, 28032),
    (1, 300, 132): (64, 4, 75, 9, 64, 64, 19, 95, 3, 4, 130304, 78208),
    (1, 512, 132): (64, 4, 128, 9, 64, 128, 16, 128, 5, 4, 154880, 129408),
    (3, 8, 132): (64, 4, 2, 2, 16, 32, 1, 1, 2, 24, 28928, 28672),
    (3, 33, 132): (64, 4, 9, 3, 16, 32, 5, 15, 2, 8, 42240, 28160),
    (3, 300, 132): (64, 4, 75, 9, 64, 64, 19, 95, 3, 12, 130304, 78464),
    (3, 512, 132): (64, 4, 128, 9, 64, 128, 16, 128, 5, 12, 154880, 129664),
    (64, 8, 132): (64, 4, 2, 2, 16, 32, 1, 1, 2, 512, 28928, 44288),
    (64, 33, 132): (64, 4, 9, 3, 16, 32, 5, 15, 2, 144, 42240, 32512),
    (64, 300, 132): (64, 4, 75, 9, 64, 64, 19, 95, 3, 204, 130304, 84608),
    (64, 512, 132): (64, 4, 128, 9, 64, 128, 16, 128, 5, 256, 154880, 137472),
    (64, 704, 132): (64, 8, 88, 4, 64, 256, 11, 121, 7, 376, 228608, 225280),
    (96, 512, 132): (64, 8, 128, 9, 64, 128, 16, 128, 5, 384, 225536, 141568),
    (128, 8, 132): (64, 4, 4, 2, 16, 32, 1, 1, 2, 1024, 28928, 60672),
    (128, 33, 132): (64, 4, 18, 3, 16, 32, 5, 15, 2, 284, 42240, 36992),
    (128, 300, 132): (64, 8, 76, 9, 64, 64, 19, 95, 3, 408, 176384, 91136),
    (128, 512, 132): (64, 8, 128, 9, 64, 128, 16, 128, 5, 512, 225536, 145664),
    (128, 704, 132): (128, 8, 88, 4, 64, 256, 11, 121, 6, 748, 230656, 227968),
    (200, 8, 132): (64, 4, 8, 2, 16, 32, 1, 1, 2, 1600, 28928, 79104),
    (200, 33, 132): (64, 4, 36, 3, 16, 32, 5, 15, 2, 440, 42240, 41984),
    (200, 300, 132): (64, 16, 76, 5, 64, 64, 19, 95, 3, 632, 231680, 98304),
    (200, 512, 132): (128, 8, 128, 9, 64, 128, 16, 128, 5, 800, 227584,
                       154880),
    (1, 8, 114): (64, 4, 2, 2, 16, 32, 1, 1, 2, 8, 28928, 28160),
    (1, 33, 114): (64, 4, 9, 3, 16, 32, 5, 15, 2, 4, 42240, 28032),
    (1, 300, 114): (64, 4, 75, 9, 64, 64, 19, 95, 3, 4, 130304, 78208),
    (1, 512, 114): (64, 8, 64, 9, 64, 256, 8, 64, 9, 8, 225536, 231936),
    (3, 8, 114): (64, 4, 2, 2, 16, 32, 1, 1, 2, 24, 28928, 28672),
    (3, 33, 114): (64, 4, 9, 3, 16, 32, 5, 15, 2, 8, 42240, 28160),
    (3, 300, 114): (64, 4, 75, 9, 64, 64, 19, 95, 3, 12, 130304, 78464),
    (3, 512, 114): (64, 8, 64, 9, 64, 256, 8, 64, 9, 24, 225536, 232448),
    (64, 8, 114): (64, 4, 2, 2, 16, 32, 1, 1, 2, 512, 28928, 44288),
    (64, 33, 114): (64, 4, 9, 3, 16, 32, 5, 15, 2, 144, 42240, 32512),
    (64, 300, 114): (64, 4, 75, 9, 64, 64, 19, 95, 3, 204, 130304, 84608),
    (64, 512, 114): (64, 8, 64, 9, 64, 256, 8, 64, 7, 512, 225536, 229632),
    (96, 512, 114): (128, 8, 64, 9, 64, 256, 8, 64, 6, 768, 227584, 228608),
    (128, 8, 114): (64, 4, 4, 2, 16, 32, 1, 1, 2, 1024, 28928, 60672),
    (128, 33, 114): (64, 4, 18, 3, 16, 32, 5, 15, 2, 284, 42240, 36992),
    (128, 300, 114): (64, 8, 76, 9, 64, 64, 19, 95, 3, 408, 176384, 91136),
    (128, 512, 114): (128, 8, 64, 9, 64, 256, 8, 64, 5, 1024, 227584, 227584),
    (200, 8, 114): (64, 4, 8, 2, 16, 32, 1, 1, 2, 1600, 28928, 79104),
    (200, 33, 114): (64, 4, 36, 3, 16, 32, 5, 15, 2, 440, 42240, 41984),
    (200, 300, 114): (64, 16, 76, 5, 64, 64, 19, 95, 3, 632, 231680, 98304),
    (200, 512, 114): (256, 8, 64, 9, 64, 256, 8, 64, 3, 1600, 231680, 227584),
    (1, 8, 16): (64, 4, 2, 2, 16, 32, 1, 1, 2, 8, 28928, 28160),
    (1, 33, 16): (64, 4, 9, 3, 16, 32, 5, 15, 2, 4, 42240, 28032),
    (3, 8, 16): (64, 4, 2, 2, 16, 32, 1, 1, 2, 24, 28928, 28672),
    (3, 33, 16): (64, 4, 9, 3, 16, 32, 5, 15, 2, 8, 42240, 28160),
    (64, 8, 16): (64, 4, 2, 2, 16, 32, 1, 1, 2, 512, 28928, 44288),
    (64, 33, 16): (64, 4, 9, 3, 16, 32, 5, 15, 2, 144, 42240, 32512),
    (128, 8, 16): (64, 4, 4, 2, 16, 32, 1, 1, 2, 1024, 28928, 60672),
    (128, 33, 16): (64, 8, 10, 3, 16, 32, 5, 15, 2, 284, 55552, 36992),
    (200, 8, 16): (64, 4, 8, 2, 16, 32, 1, 1, 2, 1600, 28928, 79104),
    (200, 33, 16): (64, 16, 12, 3, 16, 32, 5, 15, 2, 440, 82176, 41984),
}
PLAN_FIELDS = ("f_rows", "f_units", "f_blocks", "f_stages", "b_units",
               "b_kc", "b_splits", "b_blocks", "b_stages", "b_per", "f_smem",
               "b_smem")


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_every_resident_only_plan_is_unchanged(sms):
    """A shape the resident search takes keeps its plan, field for field:
    new candidates are tried only where it finds none."""
    shapes = [k for k in RESIDENT_PLANS if k[2] == sms]
    assert len(shapes) >= 10
    for b, h, _ in shapes:
        plan = scan_grid.scan_plan("K", b, h, sms)
        assert tuple(getattr(plan, f) for f in PLAN_FIELDS) == \
            RESIDENT_PLANS[(b, h, sms)], (b, h, sms)
        assert plan.f_kind == plan.b_kind == scan_grid.RESIDENT


REACH_B = (1, 2, 63, 64, 65, 127, 129, 255, 511, 513, 1000, 1025, 2047, 2048)
REACH_H = (1, 2, 31, 33, 100, 511, 703, 705, 735, 737, 900, 1023, 1025, 1500,
           2047, 2048)


@pytest.mark.parametrize("sms", [132, 114])
def test_every_b_and_h_up_to_2048_plans(sms):
    """On an SXM (132 SMs) and a PCIe (114) H100, every B and H in 1 to
    2048 has a plan (sampled at the edges of 64-row passes, 32-deep tiles
    and the resident reach); past the resident reach a direction is
    streamed."""
    kinds = set()
    for b in REACH_B:
        for h in REACH_H:
            plan = scan_grid.scan_plan("K", b, h, sms)
            assert plan.f_smem <= scan_grid.SG_SMEM_LIMIT
            assert plan.b_smem <= scan_grid.SG_SMEM_LIMIT
            assert plan.f_blocks <= sms and plan.b_blocks <= sms
            kinds.add((plan.f_kind, plan.b_kind))
    assert kinds == {(0, 0), (0, 1), (1, 1)}


def test_the_main_path_shapes():
    """K3 at B 64 and K8 at B 128 (H 512): 128 blocks each way; the
    forward one 64-row pass of 4 (K3) or 8 (K8) units, the backward 64
    units over 16 k ranges of 128, so a step's A reads through L2 are 4 MB
    (K3) or 8 MB (K8) for the backward, where cutting by units alone would
    read 64 MB."""
    k3 = scan_grid.scan_plan("K3", 64, 512)
    k8 = scan_grid.scan_plan("K8", 128, 512)
    assert (k3.f_rows, k3.f_units, k3.f_blocks) == (64, 4, 128)
    assert (k8.f_rows, k8.f_units, k8.f_blocks) == (64, 8, 128)
    # 8 of the 16 k tiles of h_{t-1} in flight
    assert (k3.f_stages, k8.f_stages) == (9, 9)
    for p in (k3, k8):
        assert (p.b_units, p.b_kc, p.b_splits, p.b_blocks) == (64, 128, 16,
                                                               128)
        assert p.b_stages == 5
    assert k8.b_blocks * 128 * k8.b_kc * 4 == 8 << 20


def test_k4_plans_as_k3_at_the_main_path_shape_and_refuses_wide_h():
    """K4 (B 64, H 512) takes K3's plan: the recurrence depends on (B, H)
    alone.  Its old step kernels took any H; the resident slice of W_hh
    reaches H = 704, the streamed plan past it up to 2048 (736: the forward
    still resident, the backward streamed; 1024 and 2048 both streamed),
    and H = 2049 is refused."""
    k4 = scan_grid.scan_plan(nic_scan.WHAT, 64, 512)
    assert k4 == scan_grid.scan_plan("K3", 64, 512)
    assert (k4.f_rows, k4.f_units, k4.f_blocks) == (64, 4, 128)
    assert (k4.b_units, k4.b_kc, k4.b_splits, k4.b_blocks) == (64, 128, 16,
                                                               128)
    R, S = scan_grid.RESIDENT, scan_grid.STREAMED
    for b in (1, 64, 128):
        p = scan_grid.scan_plan("K4", b, 704)
        assert (p.f_kind, p.b_kind) == (R, R)
        p = scan_grid.scan_plan(nic_scan.WHAT, b, 736)
        assert (p.f_kind, p.b_kind) == (R, S)
        for h in (1024, 2048):
            p = scan_grid.scan_plan(nic_scan.WHAT, b, h)
            assert (p.f_kind, p.b_kind) == (S, S)
        with pytest.raises(ValueError, match="K4 .*H = 2049"):
            scan_grid.scan_plan(nic_scan.WHAT, b, 2049)


def test_a_shape_that_fits_no_partition_raises_naming_the_kernel():
    with pytest.raises(ValueError, match="K3 .*H = 2049"):
        scan_grid.scan_plan("K3 (csrc/lstm_scan.cu)", 64, 2049)
    with pytest.raises(ValueError, match="K3 .*B = 4096, H = 2049"):
        scan_grid.scan_plan("K3 (csrc/lstm_scan.cu)", 4096, 2049)
    # B H past 2^31 (the gate pass's element count) has no streamed plan
    with pytest.raises(ValueError, match="K3 .*B = 1048576, H = 2048"):
        scan_grid.scan_plan("K3 (csrc/lstm_scan.cu)", 1 << 20, 2048)
    with pytest.raises(ValueError, match="K8"):
        scan_grid.scan_plan("K8 (csrc/senticap_scan.cu)", 1, 4096)
    with pytest.raises(ValueError, match="K8"):
        scan_grid.scan_plan("K8", 0, 512)
    # past the streamed reach a resident plan still takes what it took
    p = scan_grid.scan_plan("K3", 4096, 128)
    assert (p.f_kind, p.b_kind) == (scan_grid.RESIDENT, scan_grid.RESIDENT)


# sha256 of every plan over REACH_B x REACH_H (B up to 2048), field by
# field.  Lifting the batch cap changed no plan; the streamed items of 128
# rows (b_rows, the backward's; the forward's where H % 4 == 0), and the
# streamed forward in place of a resident one whose 2-stage ring holds one
# of a pass's k tiles in flight, changed 106 of the 224 on 132 SMs (41
# forwards: 30 streamed ones now 128-row items, 11 resident ones now
# streamed; 102 backwards: 98 streamed ones now 128-row items, 2 resident
# ones now streamed, 2 other k ranges) and 111 on 114; the rest keep every
# field.
PLANS_UP_TO_2048 = {
    132: "c20df62c3041393e3655c82cb5a4cb21fdd6711afec61f3921cf5a30e2b770a7",
    114: "8106fa2e1ee6fbae096ff2383d556c84109519b6e26dd2763d7ca286aeec82a7"}


@pytest.mark.parametrize("sms", sorted(PLANS_UP_TO_2048))
def test_every_plan_up_to_b_2048_is_unchanged(sms):
    d = hashlib.sha256()
    for b in REACH_B:
        for h in REACH_H:
            p = scan_grid.scan_plan("K", b, h, sms)
            d.update(repr(tuple(getattr(p, f) for f, _ in
                                scan_grid._CPlan._fields_)).encode())
    assert d.hexdigest() == PLANS_UP_TO_2048[sms]


# Batches past 2048 (the streamed plan took none before): the large-batch
# epochs on an 80 GB card
PAST_2048 = [(2049, 512), (2560, 512), (4096, 512), (8192, 512),
             (4096, 256), (8192, 128), (2560, 1024), (3000, 700)]


@pytest.mark.parametrize("b,h", PAST_2048)
def test_batches_past_2048_plan_and_own_every_element_once(b, h):
    """B past 2048 at H <= 2048 has a plan: its streamed directions cut
    the batch into 64-row items like any other B, every (row, unit) and
    (pass, unit, k tile) owned once, every gate-pass element in one
    block's range, each block within the card and its shared memory."""
    test_every_unit_row_and_k_is_owned_once(b, h)
    for sms in (132, 114):
        test_blocks_fit_the_card_one_an_sm(b, h, sms)


@pytest.mark.parametrize("sms", [132, 114])
def test_a_batch_past_2048_keeps_the_plan_of_its_kind(sms):
    """A resident direction at B > 2048 (small H) plans as it did; the
    backward past the resident reach streams, its blocks at most one an
    SM, and a streamed block's shared memory is its units' ring and tiles,
    whatever B is."""
    p = scan_grid.scan_plan("K3", 4096, 128, sms)
    assert p.f_kind == scan_grid.RESIDENT
    assert p.b_kind == (scan_grid.RESIDENT if sms == 132 else
                        scan_grid.STREAMED)
    for b, h in ((2049, 512), (4096, 512), (8192, 512), (4096, 1024)):
        p = scan_grid.scan_plan("K3", b, h, sms)
        assert p.b_kind == scan_grid.STREAMED
        assert p.f_blocks <= sms and p.b_blocks <= sms
        mt = p.b_rows // 64
        assert p.b_smem == (scan_grid.stream_rest(p.b_units, mt) + p.b_stages
                            * scan_grid.stream_stage_bytes(p.b_units, mt))
        if p.f_kind == scan_grid.STREAMED:
            nc, mt = 4 * p.f_units, p.f_rows // 64
            assert p.f_smem == (scan_grid.stream_rest(nc, mt) + p.f_stages
                                * scan_grid.stream_stage_bytes(nc, mt))


def test_the_plan_is_a_pure_function_of_the_shape():
    assert scan_grid.scan_plan("a", 128, 512) == scan_grid.scan_plan(
        "b", 128, 512)
    assert scan_grid.scan_plan("a", 1, 300) != scan_grid.scan_plan(
        "a", 200, 300)


# --- the sources -----------------------------------------------------------------

def _struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\};" % name, HEADER, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype = "long long" if decl.startswith("long long") else "int"
        fields += [(n.strip(), ctype) for n in decl[len(ctype):].split(",")]
    return fields


def test_the_ctypes_plan_mirrors_the_sources_struct():
    types = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    assert [(f, types[t]) for f, t in scan_grid._CPlan._fields_] == \
        _struct_fields("ScanPlan")
    plan = scan_grid.scan_plan("K3", 64, 512)
    c = plan.c_struct()
    assert [getattr(c, f) for f, _ in c._fields_] == [
        getattr(plan, f) for f, _ in c._fields_]


def test_the_wrappers_geometry_is_the_kernels():
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+(?: \+ \d+)?);",
                             HEADER))
    assert int(consts["SG_THREADS"]) == scan_grid.SG_THREADS
    assert int(consts["SG_ROWS"]) == scan_grid.SG_ROWS
    assert int(consts["SG_BK"]) == scan_grid.SG_BK
    assert consts["SG_LDA"] == "SG_BK + 4"
    assert int(consts["SG_MAX_STAGES"]) == scan_grid.SG_MAX_STAGES
    assert int(consts["SG_SMEM_LIMIT"]) == scan_grid.SG_SMEM_LIMIT
    # the streamed plans: the kinds, the reach, an item's fixed cost
    assert int(consts["SG_RESIDENT"]) == scan_grid.RESIDENT
    assert int(consts["SG_STREAMED"]) == scan_grid.STREAMED
    assert int(consts["SG_STREAM_MAX"]) == scan_grid.STREAM_MAX
    assert int(consts["SG_ITEM_TILES"]) == scan_grid.SG_ITEM_TILES
    assert "for (int u = 4; u <= 16; u *= 2)" in HEADER     # FWD_UNITS
    assert "for (int u = 16; u <= 64; u *= 2)" in HEADER    # BWD_UNITS
    assert scan_grid.FWD_UNITS == (4, 8, 16)
    assert scan_grid.BWD_UNITS == (16, 32, 64)
    # the streamed items: their units, M tiles, and the plan key's flight
    assert "for (int u = 8; u <= 16; u *= 2) {   // streamed" in HEADER
    assert "for (int u = 32; u <= 64; u *= 2) {   // streamed" in HEADER
    assert scan_grid.STREAM_FWD_UNITS == (8, 16)
    assert scan_grid.STREAM_BWD_UNITS == (32, 64)
    assert int(consts["SG_MAX_MT"]) == scan_grid.SG_MAX_MT == 2
    assert int(consts["SG_FLIGHT_BYTES"]) == scan_grid.SG_FLIGHT_BYTES
    assert "__launch_bounds__(SG_THREADS, 1)" in HEADER


def _c_params(source: str, fn: str) -> int:
    sig = re.search(r"\b%s\((.*?)\)\s*\{" % fn, source, re.S).group(1)
    return len([p for p in sig.split(",") if p.strip()])


@pytest.mark.parametrize("module,source,fn", [
    (lstm_scan, "lstm_scan.cu", "icee_lstm_scan_workspace"),
    (lstm_scan, "lstm_scan.cu", "icee_lstm_scan_fwd"),
    (lstm_scan, "lstm_scan.cu", "icee_lstm_scan_bwd"),
    (lstm_scan, "lstm_scan.cu", "icee_scan_product_ws"),
    (lstm_scan, "lstm_scan.cu", "icee_scan_product"),
    (ss, "senticap_scan.cu", "icee_senticap_scan_workspace"),
    (ss, "senticap_scan.cu", "icee_senticap_scan_fwd"),
    (ss, "senticap_scan.cu", "icee_senticap_scan_bwd"),
    (nic_scan, "nic_scan.cu", "icee_nic_scan_workspace"),
    (nic_scan, "nic_scan.cu", "icee_nic_scan_fwd"),
    (nic_scan, "nic_scan.cu", "icee_nic_scan_bwd"),
    (lstm_scan, "lstm_scan.cu", "icee_scan_recurrence_launches"),
    (ss, "senticap_scan.cu", "icee_scan_recurrence_launches"),
    (nic_scan, "nic_scan.cu", "icee_scan_recurrence_launches"),
])
def test_the_ctypes_signatures_match_the_entry_points(module, source, fn,
                                                      monkeypatch):
    declared = {}

    def fake_library(name, signatures):
        declared.update(signatures)
        raise RuntimeError("stop")

    monkeypatch.setattr(cuda_lib, "library", fake_library)
    with pytest.raises(RuntimeError, match="stop"):
        module._library()
    assert len(declared[fn][0]) == _c_params(
        (CSRC / source).read_text(), fn)


def test_no_step_kernel_and_no_cuda_core_product_in_the_scans():
    """K3, K4 and K8 launch the recurrence once a direction and no product
    of gemm_f32.cuh: their sources call neither a step kernel nor gemm(),
    and scan_step.cuh defines no step kernel any more."""
    for name in ("lstm_scan.cu", "senticap_scan.cu", "nic_scan.cu"):
        src = (CSRC / name).read_text()
        assert "fwd_step_kernel" not in src and "bwd_step_kernel" not in src
        assert not re.search(r"\bgemm\(", src)
        assert "scan_fwd_grid<" in src and "scan_bwd_grid<" in src
        assert "sb_product(" in src and "tf32x3_gemm(" in src
    nic = (CSRC / "nic_scan.cu").read_text()
    assert "scan_fwd_grid<NicGates>" in nic and "scan_bwd_grid<NicGates>" in nic
    step = (CSRC / "scan_step.cuh").read_text()
    assert "__global__" not in step and "_step_kernel" not in step


# --- the kernels' arithmetic ------------------------------------------------------

def _close(got, want, rel=1e-3):
    err = (got - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1e-6), (err, rel)


def _factored_params(rng, e, f, h):
    def t(a):
        return torch.tensor(a.astype(np.float32))

    return {"V_w": t(rng.uniform(-1, 1, (e, 4 * f)) / np.sqrt(e)),
            "V_b": t(0.1 * rng.standard_normal((4, f))),
            "S_w": t(rng.uniform(-1, 1, (4, f, f)) / np.sqrt(f)),
            "S_b": t(0.1 * rng.standard_normal((4, f))),
            "U_w": t(rng.uniform(-1, 1, (4, f, h)) / np.sqrt(f)),
            "U_b": t(0.1 * rng.standard_normal((4, h))),
            "W_w": t(rng.uniform(-1.5, 1.5, (h, 4 * h)) / np.sqrt(h)),
            "W_b": t(0.1 * rng.standard_normal((4, h)))}


def _double(params):
    return {k: v.double() for k, v in params.items()}


def _against_pallas(kernel, args, h_seq, dh, grads):
    """The JAX package's Pallas kernel ``kernel`` (interpret mode) on the
    same inputs ``args`` (a tuple of arrays or dicts of them): its h_seq
    within 1e-4 of ``h_seq``, and its ``jax.vjp`` on the cotangent ``dh``
    against ``grads`` (one entry a positional argument, dicts by name),
    each within 1e-3 of its largest magnitude."""
    def j(t):
        return jnp.asarray(t.numpy())

    jargs = tuple({k: j(v) for k, v in a.items()} if isinstance(a, dict)
                  else j(a) for a in args)
    h, vjp = jax.vjp(kernel, *jargs)
    assert np.abs(np.asarray(h) - h_seq.numpy()).max() <= 1e-4
    for got, want in zip(grads, vjp(j(dh))):
        pairs = ([(got[k], want[k]) for k in got] if isinstance(got, dict)
                 else [(got, want)])
        for g, w in pairs:
            _close(g, torch.tensor(np.asarray(w)))


# (B, E, F, H): the small widths, then H = 768 and 1024, past the
# resident plan's reach (streamed plans), at a batch the Pallas kernels
# take (a multiple of 8)
@pytest.mark.parametrize("b,e,f,h", [(6, 12, 16, 24), (3, 20, 24, 40),
                                     (8, 12, 16, 768), (8, 12, 16, 1024)])
def test_k3_arithmetic_through_25_steps(b, e, f, h):
    rng = np.random.default_rng(b + h)
    t = 25
    p = _factored_params(rng, e, f, h)
    x = torch.tensor((0.5 * rng.standard_normal((b, t, e))).astype(np.float32))
    dh = torch.tensor((0.02 * rng.standard_normal((b, t, h))).astype(
        np.float32))
    plan = scan_grid.scan_plan("K3", b, h)
    h_seq, c_seq, saved = scan_grid.factored_scan_tc_plain(p, x)
    want_h, want_c = lstm_scan.fused_factored_scan_plain(p, x)
    h64, c64 = lstm_scan.fused_factored_scan_plain(_double(p), x.double())
    for got, want in ((h_seq, want_h), (c_seq, want_c), (h_seq, h64),
                      (c_seq, c64)):
        assert (got.double() - want.double()).abs().max().item() <= 1e-4
    dx, grads = scan_grid.factored_scan_bwd_tc_plain(p, x, h_seq, c_seq, dh,
                                                     saved, plan)
    want_dx, want_g = lstm_scan.factored_scan_bwd_plain(p, x, h_seq, c_seq,
                                                        dh)
    dx64, g64 = lstm_scan.factored_scan_bwd_plain(
        _double(p), x.double(), h_seq.double(), c_seq.double(), dh.double())
    _close(dx, want_dx)
    _close(dx.double(), dx64)
    for k in lstm_scan.CELL_KEYS:
        _close(grads[k], want_g[k])
        _close(grads[k].double(), g64[k])
    # the saved tensors are the ones the kernel backward reads
    v, s, acts = saved
    assert v.shape == (b * t, 4 * f) and s.shape == (b * t, 4 * f)
    assert acts.shape == (b, t, 4, h)
    if b % 8 == 0:
        _against_pallas(lambda p, x: jax_k3(p, x, True), (p, x), h_seq, dh,
                        (grads, dx))


@pytest.mark.parametrize("gclip", [5.0, 0.01])
@pytest.mark.parametrize("b,e,h", [(5, 20, 32), (2, 16, 44), (8, 16, 768),
                                   (8, 16, 1024)])
def test_k8_arithmetic_through_25_steps(b, e, h, gclip):
    rng = np.random.default_rng(b * h)
    t = 25
    # U(-0.6, 0.6) up to 60 inputs a gate, then the bound shrinks as
    # 1 / sqrt(E + H) (the model's Xavier law): the cell (h = o c, no tanh)
    # stays out of the chaotic regime, where float32 and float64 part
    # ways whatever the order of the sums, at every width
    bound = 0.6 * min(1.0, (60 / (e + h)) ** 0.5)
    w = torch.tensor(rng.uniform(-bound, bound, (e + h, 4 * h)).astype(
        np.float32))
    x = torch.tensor(rng.standard_normal((b, t, e)).astype(np.float32))
    dh = torch.tensor(rng.standard_normal((b, t, h)).astype(np.float32))
    plan = scan_grid.scan_plan("K8", b, h)
    assert plan.b_splits > 1        # the partials are added in order
    h_seq, c_seq, acts = scan_grid.senticap_scan_tc_plain(w, x)
    want_h, want_c = ss.fused_senticap_scan_plain(w, x)
    h64, c64 = ss.fused_senticap_scan_plain(w.double(), x.double())
    for got, want in ((h_seq, want_h), (c_seq, want_c), (h_seq, h64),
                      (c_seq, c64)):
        assert (got.double() - want.double()).abs().max().item() <= 1e-4
    dx, dw = scan_grid.senticap_scan_bwd_tc_plain(w, x, h_seq, c_seq, dh,
                                                  gclip, acts, plan)
    want_dx, want_dw = ss.senticap_scan_bwd_plain(w, x, h_seq, c_seq, dh,
                                                  gclip)
    dx64, dw64 = ss.senticap_scan_bwd_plain(w.double(), x.double(),
                                            h_seq.double(), c_seq.double(),
                                            dh.double(), gclip)
    _close(dx, want_dx)
    _close(dw, want_dw)
    _close(dx.double(), dx64)
    _close(dw.double(), dw64)
    if gclip < 1:   # the clamp binds: it changes dW
        loose = ss.senticap_scan_bwd_plain(w, x, h_seq, c_seq, dh, 1e9)[1]
        assert not torch.allclose(loose, want_dw)
    if b % 8 == 0:
        _against_pallas(lambda w, x: jax_k8(w, x, gclip, None, True), (w, x),
                        h_seq, dh, (dw, dx))


def _nic_cell(rng, e, h):
    def t(a):
        return torch.tensor(a.astype(np.float32))

    return {"W_ih": t(rng.uniform(-1, 1, (e, 4 * h)) / np.sqrt(e)),
            "W_hh": t(rng.uniform(-1.5, 1.5, (h, 4 * h)) / np.sqrt(h)),
            "b_ih": t(0.1 * rng.standard_normal(4 * h)),
            "b_hh": t(0.1 * rng.standard_normal(4 * h))}


@pytest.mark.parametrize("b,e,h", [(6, 20, 36), (3, 13, 44), (8, 13, 768),
                                   (8, 13, 1024)])
def test_k4_arithmetic_through_25_steps(b, e, h):
    rng = np.random.default_rng(7 * b + h)
    t = 25
    cell = _nic_cell(rng, e, h)
    x = torch.tensor((0.5 * rng.standard_normal((b, t, e))).astype(
        np.float32))
    dh = torch.tensor((0.02 * rng.standard_normal((b, t, h))).astype(
        np.float32))
    plan = scan_grid.scan_plan("K4", b, h)
    assert plan.b_splits > 1        # the partials are added in order
    h_seq, c_seq, acts = scan_grid.nic_scan_tc_plain(cell, x)
    want_h, want_c = nic_scan.fused_nic_scan_plain(cell, x)
    h64, c64 = nic_scan.fused_nic_scan_plain(_double(cell), x.double())
    for got, want in ((h_seq, want_h), (c_seq, want_c), (h_seq, h64),
                      (c_seq, c64)):
        assert (got.double() - want.double()).abs().max().item() <= 1e-4
    assert acts.shape == (b, t, 4, h)
    dx, grads = scan_grid.nic_scan_bwd_tc_plain(cell, x, h_seq, c_seq, dh,
                                                acts, plan)
    want_dx, want_g = nic_scan.nic_scan_bwd_plain(cell, x, h_seq, c_seq, dh)
    dx64, g64 = nic_scan.nic_scan_bwd_plain(
        _double(cell), x.double(), h_seq.double(), c_seq.double(),
        dh.double())
    _close(dx, want_dx)
    _close(dx.double(), dx64)
    for k in nic_scan.CELL_KEYS:
        _close(grads[k], want_g[k])
        _close(grads[k].double(), g64[k])
    assert torch.equal(grads["b_ih"], grads["b_hh"])
    if b % 8 == 0:
        _against_pallas(lambda c, x: jax_k4(c, x, None, True), (cell, x),
                        h_seq, dh, (grads, dx))


def test_scan_product_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.standard_normal((4, 7, 9)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((4, 9, 5)).astype(np.float32))
    bias = torch.tensor(rng.standard_normal((4, 5)).astype(np.float32))
    before = scan_grid.scan_product.launches
    got = scan_grid.scan_product(a, b, "N", bias)
    assert scan_grid.scan_product.launches == before
    ref = a.double() @ b.double() + bias.double()[:, None]
    assert (got.double() - ref).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="no bias"):
        scan_grid.scan_product(a.transpose(1, 2), b, "A", bias)


# --- items of several M tiles (wider streamed items) and the plan cache ------

WIDE_ITEM_SHAPES = [(4096, 512), (64, 1024), (64, 2048)]


@pytest.mark.parametrize("b,h", WIDE_ITEM_SHAPES)
@pytest.mark.parametrize("sms", [132, 114])
def test_the_wide_item_plans_own_every_element_once_and_fit(b, h, sms):
    """At B = 4096 (H = 512) both directions stream in items of 128 rows
    (two 64-row M tiles sharing each tile of W_h's planes), the forward
    in place of the resident plan whose 2-stage ring held one tile in
    flight; at B = 64 (H = 1024, 2048) an item is one M tile.  Every (row,
    unit) and (pass, unit, k tile) is owned once, every gate element by
    one block, and each block fits the card and its shared memory."""
    plan = scan_grid.scan_plan("K4", b, h, sms)
    assert plan.f_kind == plan.b_kind == scan_grid.STREAMED
    rows = 128 if b == 4096 else 64
    assert plan.f_rows == plan.b_rows == rows
    assert plan.f_stages >= 5 and plan.b_stages >= 5
    test_blocks_fit_the_card_one_an_sm(b, h, sms)
    if sms == 132:
        test_every_unit_row_and_k_is_owned_once(b, h)


def test_b_4096_streams_where_its_resident_ring_held_one_tile():
    """The resident forward at B = 4096 (2,048 rows a block, 2 ring
    stages: each of a step's 512 k tiles waits on L2 alone) costs its
    busiest block more than the streamed plan's (items of 128 rows behind
    5 stages), counted by ``tile_cost``: the streamed plan is taken.  The
    main path's shapes keep their resident plans."""
    b, h, nk = 4096, 512, 16
    res = 2048 // 64 * nk * scan_grid.tile_cost(1, 0, 2)
    plan = scan_grid.scan_plan("K4", b, h)
    items = math.ceil(b / plan.f_rows) * math.ceil(h / plan.f_units)
    busiest = math.ceil(items / plan.f_blocks) * scan_grid.stream_item_bytes(
        nk, 4 * plan.f_units, plan.f_rows // 64, plan.f_stages)
    assert busiest < res
    for what, bb in (("K3", 64), ("K4", 64), ("K8", 128)):
        p = scan_grid.scan_plan(what, bb, 512)
        assert p.f_kind == p.b_kind == scan_grid.RESIDENT


def test_a_second_plan_call_costs_no_search(monkeypatch):
    """A plan is derived once a (B, H, SM count): a second call returns the
    same object without searching again (``scan_grid._search`` is not
    called), whatever the kernel's name."""
    first = scan_grid.scan_plan("K4", 777, 1500, 97)
    calls = []
    monkeypatch.setattr(scan_grid, "_search",
                        lambda *a: calls.append(a) or first)
    assert scan_grid.scan_plan("K3", 777, 1500, 97) is first
    assert not calls
    scan_grid.scan_plan("K4", 778, 1500, 97)
    assert calls == [("K4", 778, 1500, 97)]
    del scan_grid._PLANS[(778, 1500, 97)]   # the fake search's answer


def test_a_workspace_is_asked_once_a_shape():
    """``scan_grid.workspace`` asks the library's size query once a (query,
    plan, dims) and keeps its answer and the plan's ctypes struct."""
    asked = []

    def icee_fake_scan_workspace(cplan, *args):
        *dims, out = args
        asked.append(tuple(dims))
        sizes = ctypes.cast(out, ctypes.POINTER(ctypes.c_longlong))
        sizes[0], sizes[1] = 5, 7

    plan = scan_grid.scan_plan("K4", 64, 512)
    cpu = torch.device("cpu")
    c1, w1 = scan_grid.workspace(icee_fake_scan_workspace, plan,
                                 (64, 25, 300, 512), 0, cpu)
    c2, w2 = scan_grid.workspace(icee_fake_scan_workspace, plan,
                                 (64, 25, 300, 512), 1, cpu)
    assert asked == [(64, 25, 300, 512)]
    assert c1 is c2 and w1.shape == (5,) and w2.shape == (7,)
    assert c1.b_rows == plan.b_rows and c1.f_rows == plan.f_rows


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_arithmetic_through_25_steps_on_wide_items(kernel, monkeypatch):
    """The kernels' arithmetic (``scan_grid.*_tc_plain``) where the plan
    streams both directions in items of 128 rows: B = 96, H = 96 on a
    4-SM card, the backward's two k ranges of 192 added in order; held
    against the plain scans, float64 and the JAX Pallas kernels as the
    tests above hold it."""
    plan_of = scan_grid.scan_plan
    plan = plan_of(kernel, 96, 96, 4)
    assert plan.f_kind == plan.b_kind == scan_grid.STREAMED
    assert plan.f_rows == plan.b_rows == 128
    assert (plan.b_kc, plan.b_splits) == (192, 2)
    monkeypatch.setattr(scan_grid, "scan_plan",
                        lambda what, b, h, sms=4: plan_of(what, b, h, sms))
    if kernel == "K3":
        test_k3_arithmetic_through_25_steps(96, 12, 16, 96)
    else:
        test_k4_arithmetic_through_25_steps(96, 13, 96)
