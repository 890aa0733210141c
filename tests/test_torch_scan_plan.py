"""The host side and the arithmetic of K3, K4 and K8 (the StyleNet, NIC
and SentiCap training scans: ``csrc/lstm_scan.cu``, ``csrc/nic_scan.cu``,
``csrc/senticap_scan.cu``, their recurrence in ``csrc/scan_grid.cuh``)
that the CPU can check, without JAX:

- the recurrence's launch plan (``ops/scan_grid.py::scan_plan``) at the
  main path's shapes (K3 and K4: B 64, H 512; K8: B 128, H 512) and at edge
  shapes (B 1, 3, 200; H 8, 33, 300): every (row, unit) of the forward and
  every (unit, k) of the backward's product owned by one block, shared
  memory within a block's 227 KB, at most one block an SM, the choice at
  the main shapes, and the refusal of a shape that fits no partition,
  naming the kernel;
- the ctypes mirror of the source's ``ScanPlan``, the geometry constants
  and the C entry points' argument counts, held against the sources' text;
- the kernels' arithmetic in tensor ops (``scan_grid.*_tc_plain``: every
  product 3xTF32 through ``att_scan.tf32x3_product_plain``, the backward's
  recurrent dh as the plan's k ranges added in range order, then clamped)
  over T = 25 steps at small width, against the unchanged plain scans and
  float64 within phases 7 and 12's tolerances (h and c atol 1e-4, each
  gradient within 1e-3 of its largest magnitude), K8 at gclip 5.0 and at
  0.01, where the clamp binds, K4 with H not a multiple of 32.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch.ops import cuda_lib, lstm_scan, nic_scan, scan_grid
from icee_tpu_torch.ops import senticap_scan as ss

CSRC = Path(scan_grid.__file__).resolve().parents[1] / "csrc"
HEADER = (CSRC / "scan_grid.cuh").read_text()

EDGE = [(b, h) for b in (1, 3, 64, 128, 200) for h in (8, 33, 300, 512)]


def _owners_fwd(plan):
    own = np.zeros((plan.B, plan.H), dtype=np.int64)
    for q in range(plan.f_blocks):
        rows, units = plan.fwd_block(q)
        own[rows.start:rows.stop, units.start:units.stop] += 1
    return own


def _owners_bwd(plan):
    own = np.zeros((plan.H, 4 * plan.H), dtype=np.int64)
    for q in range(plan.b_blocks):
        units, ks = plan.bwd_block(q)
        own[units.start:units.stop, ks.start:ks.stop] += 1
    return own


@pytest.mark.parametrize("b,h", EDGE)
def test_every_unit_row_and_k_is_owned_once(b, h):
    plan = scan_grid.scan_plan("K", b, h)
    assert (_owners_fwd(plan) == 1).all()
    assert (_owners_bwd(plan) == 1).all()
    # the backward's gate pass: every (b, j) element in one block's range
    gates = np.zeros(b * h, dtype=np.int64)
    for q in range(plan.b_blocks):
        els = plan.gate_block(q)
        assert len(els) <= plan.b_per
        gates[els.start:els.stop] += 1
    assert (gates == 1).all()
    # no block is empty: the plan launches no idle block
    for q in range(plan.f_blocks):
        rows, units = plan.fwd_block(q)
        assert len(rows) and len(units)
    for q in range(plan.b_blocks):
        units, ks = plan.bwd_block(q)
        assert len(units) and len(ks)


@pytest.mark.parametrize("b,h", EDGE)
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_blocks_fit_the_card_one_an_sm(b, h, sms):
    try:
        plan = scan_grid.scan_plan("K", b, h, sms)
    except ValueError as e:
        assert sms < 132 and "no launch plan" in str(e)
        return
    assert 1 <= plan.f_blocks <= sms and 1 <= plan.b_blocks <= sms
    assert plan.f_smem <= scan_grid.SG_SMEM_LIMIT == cuda_lib.SMEM_LIMIT
    assert plan.b_smem <= scan_grid.SG_SMEM_LIMIT
    # shared memory as the kernels lay it out: the slice's hi and lo words,
    # the A ring, the forward's out and c tiles, the backward's out tile and
    # gate-pass tiles (8 words an element)
    kd = min(plan.b_kc, -(-4 * h // 32) * 32)
    nc, u = 4 * plan.f_units, plan.f_units
    tile = 4 * 64 * 36
    assert plan.b_smem == (2 * 4 * plan.b_units * kd + 1024
                           + 4 * 64 * (plan.b_units + 1) + 32 * plan.b_per
                           + plan.b_stages * tile)
    assert plan.f_smem == (2 * 4 * nc * (-(-h // 32) * 32) + 1024
                           + 4 * (64 * (nc + 1) + plan.f_rows * u)
                           + plan.f_stages * tile)
    # every tile of a pass in flight where shared memory allows
    assert 2 <= plan.f_stages <= min(-(-h // 32) + 1, 9)
    assert 2 <= plan.b_stages <= min(kd // 32 + 1, 9)
    assert plan.b_per % 4 == 0 and plan.b_per * plan.b_blocks >= b * h
    assert plan.f_rows % scan_grid.SG_ROWS == 0
    # wgmma's N: all of a block's columns
    assert 4 * plan.f_units in (16, 32, 64)
    assert plan.b_units in (16, 32, 64)
    assert plan.b_splits == math.ceil(4 * h / plan.b_kc)


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
    caps H at the plan's reach (704 fits, 736 does not)."""
    k4 = scan_grid.scan_plan(nic_scan.WHAT, 64, 512)
    assert k4 == scan_grid.scan_plan("K3", 64, 512)
    assert (k4.f_rows, k4.f_units, k4.f_blocks) == (64, 4, 128)
    assert (k4.b_units, k4.b_kc, k4.b_splits, k4.b_blocks) == (64, 128, 16,
                                                               128)
    for b in (1, 64, 128):
        assert scan_grid.scan_plan("K4", b, 704).f_blocks > 0
        with pytest.raises(ValueError, match="K4 .*H = 736"):
            scan_grid.scan_plan(nic_scan.WHAT, b, 736)


def test_a_shape_that_fits_no_partition_raises_naming_the_kernel():
    with pytest.raises(ValueError, match="K3 .*H = 1024"):
        scan_grid.scan_plan("K3 (csrc/lstm_scan.cu)", 64, 1024)
    with pytest.raises(ValueError, match="K8"):
        scan_grid.scan_plan("K8 (csrc/senticap_scan.cu)", 1, 2048)
    with pytest.raises(ValueError, match="K8"):
        scan_grid.scan_plan("K8", 0, 512)


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
    assert "for (int u = 4; u <= 16; u *= 2)" in HEADER     # FWD_UNITS
    assert "for (int u = 16; u <= 64; u *= 2)" in HEADER    # BWD_UNITS
    assert scan_grid.FWD_UNITS == (4, 8, 16)
    assert scan_grid.BWD_UNITS == (16, 32, 64)
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


@pytest.mark.parametrize("b,e,f,h", [(6, 12, 16, 24), (3, 20, 24, 40)])
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


@pytest.mark.parametrize("gclip", [5.0, 0.01])
@pytest.mark.parametrize("b,e,h", [(5, 20, 32), (2, 16, 44)])
def test_k8_arithmetic_through_25_steps(b, e, h, gclip):
    rng = np.random.default_rng(b * h)
    t = 25
    w = torch.tensor(rng.uniform(-0.6, 0.6, (e + h, 4 * h)).astype(
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


def _nic_cell(rng, e, h):
    def t(a):
        return torch.tensor(a.astype(np.float32))

    return {"W_ih": t(rng.uniform(-1, 1, (e, 4 * h)) / np.sqrt(e)),
            "W_hh": t(rng.uniform(-1.5, 1.5, (h, 4 * h)) / np.sqrt(h)),
            "b_ih": t(0.1 * rng.standard_normal(4 * h)),
            "b_hh": t(0.1 * rng.standard_normal(4 * h))}


@pytest.mark.parametrize("b,e,h", [(6, 20, 36), (3, 13, 44)])
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
