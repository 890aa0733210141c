"""The host side and the arithmetic of K9 and K10 (the SentiCap beam-20
searches, ``csrc/senticap_beam.cuh``, their products in
``csrc/planes_product.cuh``) that the CPU can check, without JAX:

- the row selection's plain emulation (``row_topk_plain``, the kernel's
  steps: each thread's least pair, the threshold, the survivors, their
  order) against a stable sort by (nll, token) on hand-made rows: the nll
  plateau, equal nll at different logits, fewer than beam tokens off the
  plateau, -0 beside +0, beam 1 and beam V, at the kernel's 256 threads and
  at fewer, so that the survivors' bound binds;
- the weight preparation's layout (``prepare_weights_plain``): transposed
  to k-contiguous rows, zero padding, each 8-deep group's (hi, lo) pairs
  where the kernel's fragment loads read them, hi + lo within 2^-22 of
  each weight through ``ops/att_scan.py::tf32_split``; and the planes'
  product against ``att_scan.tf32x3_product_plain`` bit for bit;
- the launch plan at 1, 8 and 64 images x beam 1, 5, 20 x max_len 0, 5, 20
  for both models: the planes' and the row passes' sizes, the tile width
  choice, the refusals; the ctypes mirror of the source's ``SbPlan``, the
  geometry constants and the C entry points' argument counts, held against
  the CUDA sources' text.

The kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch.ops import att_scan, cuda_lib
from icee_tpu_torch.ops import senticap_decode as sd
from icee_tpu_torch.ops import senticap_switched_decode as ssd

CSRC = Path(sd.__file__).resolve().parents[1] / "csrc"
# the searches' header and the products' (moved apart once K3 and K8 came
# to use the product too)
HEADER = ((CSRC / "senticap_beam.cuh").read_text()
          + (CSRC / "planes_product.cuh").read_text())
PLATEAU = -math.log2(1e-37)


def _stable(nll, k):
    s = torch.sort(nll, dim=1, stable=True)
    return s.values[:, :k], s.indices[:, :k].to(torch.int32)


def _rows():
    """Hand-made nll rows (V = 40): distinct values; the plateau
    everywhere; three tokens off it; equal nll at scattered tokens (what
    equal probabilities from different logits give); -0 beside +0 and
    values just above 0; integers with many repeats."""
    rng = np.random.default_rng(7)
    v = 40
    rows = [rng.uniform(0.5, 30.0, v)]
    rows.append(np.full(v, PLATEAU))
    r = np.full(v, PLATEAU)
    r[[31, 4, 17]] = [2.0, 9.0, 2.0]
    rows.append(r)
    r = rng.uniform(3.0, 30.0, v)
    r[[38, 2, 21, 9, 30]] = 1.25
    rows.append(r)
    r = rng.uniform(1.0, 30.0, v)
    r[[12, 5]] = [-0.0, 0.0]
    r[[0, 39]] = [1.4e-45, 1e-30]   # float32's least subnormal
    rows.append(r)
    rows.append(rng.integers(0, 4, v).astype(np.float64))
    return torch.tensor(np.stack(rows), dtype=torch.float32)


@pytest.mark.parametrize("threads", [256, 32, 8, 3, 1])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 20, 40])
def test_row_selection_is_a_stable_sorts_first_k(threads, k):
    nll = _rows()
    if k > min(nll.shape[1], threads):
        with pytest.raises(ValueError, match="outside"):
            sd.row_topk_plain(nll, k, threads)
        return
    got_nll, got_tok = sd.row_topk_plain(nll, k, threads)
    want_nll, want_tok = _stable(nll, k)
    assert torch.equal(got_tok, want_tok)
    assert torch.equal(got_nll, want_nll)


def test_row_selection_ranks_the_plateau_by_index():
    """Fewer than beam tokens off the plateau: those first, by nll, then
    the plateau's lowest tokens in index order, whatever their logits."""
    nll = _rows()[2:3]
    got_nll, got_tok = sd.row_topk_plain(nll, 8)
    assert got_tok.tolist() == [[17, 31, 4, 0, 1, 2, 3, 5]]
    assert got_nll[0, 3:].tolist() == [np.float32(PLATEAU).item()] * 5
    # the whole plateau: tokens 0..k-1
    assert sd.row_topk_plain(_rows()[1:2], 20)[1].tolist() == [
        list(range(20))]


def test_row_selection_counts_minus_zero_as_zero():
    nll = _rows()[4:5]
    _, tok = sd.row_topk_plain(nll, 3)
    assert tok.tolist() == [[5, 12, 0]]   # +0 (5), -0 (12): equal, by index


@pytest.mark.parametrize("vocab,k", [(8800, 20), (8800, 1), (300, 256),
                                     (257, 20), (5, 5)])
def test_row_selection_at_the_kernels_widths(vocab, k):
    """Random softmax rows at the decode's widths (saturated tails on the
    plateau in half of them): the emulation's survivors stay within the
    kernel's slots (asserted inside) and the result is a stable sort's."""
    g = torch.Generator().manual_seed(vocab + k)
    logits = torch.randn((4, vocab), generator=g) * torch.tensor(
        [[1.0], [8.0], [60.0], [200.0]])
    nll = -torch.log2(torch.softmax(logits, dim=1) + 1e-37)
    got_nll, got_tok = sd.row_topk_plain(nll, k)
    want_nll, want_tok = _stable(nll, k)
    assert torch.equal(got_tok, want_tok)
    assert torch.equal(got_nll, want_nll)


def test_row_topk_takes_the_plain_version_on_the_cpu():
    nll = _rows()
    before = sd.row_topk.launches
    got = sd.row_topk(nll, 5)
    assert sd.row_topk.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, _stable(nll, 5)))


# --- the weights' planes -----------------------------------------------------

SHAPES = [(1024, 2048), (512, 8800), (37, 70), (8, 64), (33, 1)]


@pytest.mark.parametrize("k,n", SHAPES)
def test_planes_lay_each_weight_out_k_contiguous_in_tf32_halves(k, n):
    g = torch.Generator().manual_seed(k + n)
    w = torch.randn((k, n), generator=g) * 0.1
    planes = sd.prepare_weights_plain(w)
    n_p, two_kp = sd.planes_shape(k, n)
    kp = two_kp // 2
    assert planes.shape == (n_p, two_kp)
    assert n_p % 64 == 0 and n_p - 64 < n <= n_p
    assert kp % 32 == 0 and kp - 32 < k <= kp
    hi, lo = att_scan.tf32_split(w)
    # where the kernel's tile copies read them: row n, k tile kt, the 32
    # hi values of the tile, then its 32 lo values
    for kk, nn in [(0, 0), (k - 1, n - 1), (min(5, k - 1), n // 2),
                   (k // 2, min(3, n - 1))]:
        kt, r = divmod(kk, 32)
        assert planes[nn, 64 * kt + r].item() == hi[kk, nn].item()
        assert planes[nn, 64 * kt + 32 + r].item() == lo[kk, nn].item()
    got_hi, got_lo = sd.unpack_planes(planes, k, n)
    assert torch.equal(got_hi, hi) and torch.equal(got_lo, lo)
    # each weight within 2^-22 of hi + lo, both TF32 (13 low bits clear)
    assert ((got_hi.double() + got_lo.double() - w.double()).abs()
            <= 2.0 ** -22 * w.double().abs()).all()
    for x in (got_hi, got_lo):
        assert not (x.view(torch.int32) & 0x1FFF).any()
    # zeros past K and N
    full_hi, full_lo = sd.unpack_planes(planes, kp, n_p)
    assert not full_hi[k:].any() and not full_hi[:, n:].any()
    assert not full_lo[k:].any() and not full_lo[:, n:].any()


@pytest.mark.parametrize("m,k,n,bias,batch", [
    (1280, 64, 96, True, 1), (5, 37, 70, False, 1), (7, 33, 130, True, 2),
    (3, 8, 1, False, 2)])
def test_planes_product_is_the_tf32x3_products_arithmetic(m, k, n, bias,
                                                          batch):
    g = torch.Generator().manual_seed(m + k + n)
    a = torch.rand((batch, m, k), generator=g) * 2 - 1
    w = torch.randn((batch, k, n), generator=g) * 0.05
    b = torch.randn((batch, n), generator=g) if bias else None
    planes = torch.stack([sd.prepare_weights_plain(w[z])
                          for z in range(batch)])
    if batch == 1:
        a, w, planes = a[0], w[0], planes[0]
        b = b[0] if bias else None
    before = sd.planes_product.launches
    got = sd.planes_product(a, planes, n, b)
    assert sd.planes_product.launches == before   # the CPU: plain version
    want = att_scan.tf32x3_product_plain(a, w, "N", b)
    assert torch.equal(got, want)
    ref = a.double() @ w.double()
    assert (got.double() - (ref if b is None else ref + (
        b.double()[:, None] if batch == 2 else b.double()))).abs().max() \
        <= 1e-5 * math.sqrt(k)


# --- the launch plan ---------------------------------------------------------

DIMS = dict(e=512, h=512, vocab=8800)


@pytest.mark.parametrize("paths", [1, 2])
@pytest.mark.parametrize("max_len", [0, 5, 20])
@pytest.mark.parametrize("beam", [1, 5, 20])
@pytest.mark.parametrize("n_img", [1, 8, 64])
def test_plan_sizes(n_img, beam, max_len, paths):
    e, h, vocab = DIMS["e"], DIMS["h"], DIMS["vocab"]
    plan = sd.launch_plan("K", n_img, beam, e, h, vocab, max_len, paths)
    assert (plan.cell_kp, plan.head_kp) == (1024, 512)
    assert plan.cell_planes == 2048 * 2 * 1024
    assert plan.head_planes == 8832 * 2 * 512   # 8800 rounded up to 64
    assert plan.planes_floats() == paths * (plan.cell_planes
                                            + plan.head_planes)
    assert plan.paths == paths
    slots = beam * math.ceil(vocab / sd.TOPK_THREADS)
    assert plan.topk_cap in (slots, slots + 1) and plan.topk_cap % 2 == 0
    cand = 8 * plan.topk_cap
    assert plan.topk_smem == 8 * sd.TOPK_THREADS + (
        cand + 4 * vocab if paths == 1 else 4 * vocab + max(4 * vocab, cand))
    # K10's row pass: three blocks an SM (its survivors over its dead row)
    assert paths == 1 or 3 * (plan.topk_smem + 1024 + 128) <= 233472
    seq_len = max_len + 1
    assert plan.select_smem == 4 * (2 * beam * beam + 3 * beam + beam
                                    * seq_len * (2 if paths == 2 else 1))
    assert max(plan.topk_smem, plan.select_smem) <= cuda_lib.SMEM_LIMIT
    rows = n_img * beam
    tiles = math.ceil(rows / 128) * math.ceil(4 * h / 64) * paths
    whole = math.ceil(tiles / 264) * (32 + 8)
    half = math.ceil(2 * tiles / 264) * (16 + 8)
    assert plan.cell_splits == (2 if half < whole else 1)
    c = plan.c_struct()
    assert [getattr(c, f) for f, _ in sd._CPlan._fields_] == [
        getattr(plan, f) for f, _ in sd._CPlan._fields_]


def test_plan_cuts_the_cells_k_at_the_decode_shape():
    """K9's cell at 1,280 rows is 320 tiles of 128 x 64 against 264
    two-block slots: two waves of 32 k tiles, the second 21% full; in two
    k ranges, three waves of 16 (each + 8 of fixed cost: 72 against 80).
    K10's two cells: 640 tiles in three waves, five of half depth (120
    against 120: kept whole).  The heads keep one range: they add the
    bias."""
    k9 = sd.launch_plan("K9", 64, 20, 512, 512, 8800, 20, 1)
    k10 = sd.launch_plan("K10", 64, 20, 512, 512, 8800, 20, 2)
    assert k9.cell_splits == 2 and k10.cell_splits == 1
    assert sd.product_splits(1280, 2048, 1024, 1) == 2
    # full waves gain nothing: 264 tiles are one wave either way
    assert sd.product_splits(128 * 264, 64, 1024, 1) == 1
    assert sd.product_splits(1280, 2048, 32, 1) == 1    # one k tile


@pytest.mark.parametrize("kwargs,match", [
    (dict(beam=0), "outside"), (dict(beam=9000), "outside"),
    (dict(beam=257, vocab=20000), "row top-k"),
    (dict(max_len=-1), "max_len"), (dict(n_img=0), "images"),
    (dict(beam=170), "shared memory"),             # the selection's block
    (dict(vocab=60000, paths=2), "shared memory"),  # the row pass's rows
])
def test_plan_refuses_what_the_kernels_do_not_take(kwargs, match):
    args = dict(n_img=4, beam=20, e=512, h=512, vocab=8800, max_len=20,
                paths=1)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        sd.launch_plan("K", args["n_img"], args["beam"], args["e"],
                       args["h"], args["vocab"], args["max_len"],
                       args["paths"])


def test_the_cpu_route_takes_the_plain_search_beyond_the_plan():
    """The plan's refusals are the card's: on the CPU a beam above the row
    pass's threads runs the plain search."""
    rng = np.random.default_rng(3)
    vocab, e, h, vis = 300, 8, 8, 6
    params = {k: torch.tensor(rng.standard_normal(s).astype(np.float32))
              for k, s in (("wemb", (vocab, e)), ("w_lstm", (e + h, 4 * h)),
                           ("w", (h, vocab)), ("b", (vocab,)),
                           ("wvm", (vis, e)), ("bmv", (e,)))}
    v = torch.tensor(rng.standard_normal((1, vis)).astype(np.float32))
    before = sd.mega_senticap_beam_decode.launches
    score, tokens, length = sd.mega_senticap_beam_decode(
        params, v, 1, beam_size=260, max_len=1)
    assert sd.mega_senticap_beam_decode.launches == before
    assert tokens.shape == (1, 2) and torch.isfinite(score).all()


# --- the sources -------------------------------------------------------------

def _struct_fields(name):
    body = re.search(r"struct %s \{(.*?)\};" % name, HEADER, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype = "long long" if decl.startswith("long long") else "int"
        names = decl[len(ctype):]
        fields += [(n.strip(), ctype) for n in names.split(",")]
    return fields


def test_the_ctypes_plan_mirrors_the_sources_struct():
    types = {ctypes.c_longlong: "long long", ctypes.c_int: "int"}
    assert [(f, types[t]) for f, t in sd._CPlan._fields_] == \
        _struct_fields("SbPlan")


def test_the_wrappers_geometry_is_the_kernels():
    consts = dict(re.findall(r"\b(\w+) = (\d+)[,;]", HEADER))
    assert int(consts["TOPK_THREADS"]) == sd.TOPK_THREADS
    assert int(consts["SP_BM"]) == sd.SP_BM
    assert int(consts["SP_BK"]) == sd.SP_BK
    assert int(consts["SP_NP"]) == sd.SP_NP
    assert int(consts["SP_BN"]) == sd.SP_BN
    # blocks an SM: the launch bounds and the ring's shared memory
    assert "__launch_bounds__(SP_THREADS, 2)" in HEADER
    assert sd.SP_BLOCKS_PER_SM == 2
    smem = int(consts["SP_STAGES"]) * (2 * 64 * 128 + 4 * 128 * 36) + 1024
    assert 2 * (smem + 1024) <= 233472 < 3 * (smem + 1024)


def _c_params(source: str, fn: str) -> int:
    sig = re.search(r"\b%s\((.*?)\)\s*\{" % fn, source, re.S).group(1)
    return len([p for p in sig.split(",") if p.strip()])


@pytest.mark.parametrize("module,source,fn", [
    (sd, "senticap_beam.cu", "icee_senticap_beam"),
    (sd, "senticap_beam.cu", "icee_sb_prepare"),
    (sd, "senticap_beam.cu", "icee_sb_product"),
    (sd, "senticap_beam.cu", "icee_sb_row_select"),
    (ssd, "senticap_switched_beam.cu", "icee_senticap_switched_beam"),
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
