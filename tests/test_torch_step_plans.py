"""The host side of the step and attention-training launches, no JAX: the
mirrors of ``csrc/step_kernels.cuh``'s many-row step (K1's and K6's
products over all rows, each a register-tiled launch whose tile shape
``gemm_pick`` chooses; the attention launches' groups of 8 rows; the work
buffer's planes), of ``csrc/split_step.cuh``'s shared memory (the
column-split launches, which hand a shape they do not hold to the
many-row path) and of ``csrc/att_scan.cu``'s ``datt1_cols`` (K5's d_att1
pass, split over column blocks of A past its (T, A) plane).  Every shape
the earlier launches took has a plan; the many-row path takes any width,
and only K6's attention launches, which hold a group's att2 and scores,
still raise past their bound, naming the launch.  The mirrors are held to
the CUDA sources' constants here and to the libraries themselves when
they load on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch.ops import att_decode_step, att_scan, cuda_lib
from icee_tpu_torch.ops import decode_step, widths

CSRC = Path(decode_step.__file__).resolve().parents[1] / "csrc"
STEP = (CSRC / "step_kernels.cuh").read_text()
SPLIT = (CSRC / "split_step.cuh").read_text()
SCAN = (CSRC / "att_scan.cu").read_text()
ATT = (CSRC / "att_decode_step.cu").read_text()

# (E_in, F, H) of every K1 / K6 row-tiled launch the card ran before:
# the flagship (K1 E = 300, K6 E + FS = 2348), ragged widths padded to 4,
# the card tests' narrow ones
EARLIER = [(300, 512, 512), (2348, 512, 512), (300, 512, 512),
           (300 + 2048, 512, 512), (30, 48, 64), (300, 64, 32),
           (16, 32, 32), (30 + 64, 48, 48), (30 + 64, 32, 48),
           (300, 772, 772), (2348, 544, 544)]

# The planner's rows and widths: one row, one image's beam (5, 8), just
# past the split path (9), the batched flagship (64 x 5), 1024 rows (the
# wide beams' launches) and 16,384; H = F, a ragged 1021 padded to 1024
PLAN_ROWS = (1, 5, 8, 9, 320, 1024, 16384)
PLAN_H = (512, 1024, 2048, 1021)
KINDS = ("k1", "factored", "lstm")
E, FS, A, P, V = 300, 2048, 512, 196, 8192


def _const(text: str, name: str) -> int:
    return int(re.search(r"constexpr (?:int|size_t) %s = (\d+);" % name,
                         text).group(1))


def _plan(kind, rows, h, ktop=5, k=5, **kw):
    hp = widths.quad(h)
    args = dict(a=A, p=P, fs=FS, k=k) if kind != "k1" else {}
    args.update(kw)
    return decode_step.step_plan(kind, rows, E, hp, hp, V, ktop, **args)


def test_the_mirrors_constants_are_the_kernels():
    assert _const(STEP, "GEMM_BK") == decode_step.GEMM_BK
    assert _const(STEP, "GEMM_CONFIGS") == len(decode_step.GEMM_TILES)
    assert _const(STEP, "MAX_GEMM_JOBS") == decode_step.MAX_GEMM_JOBS
    assert _const(STEP, "PART_WARPS") == decode_step.PART_WARPS
    assert _const(STEP, "GATE_THREADS") == decode_step.GATE_THREADS
    assert _const(STEP, "STEP_SMEM_MAX") == cuda_lib.SMEM_LIMIT
    # the tile table: BM 128, 64, 64, 32; BN 128, 128, 64, 64
    assert "return cfg == 0 ? 128 : cfg == 3 ? 32 : 64;" in STEP
    assert "return cfg <= 1 ? 128 : 64;" in STEP
    assert decode_step.GEMM_TILES == ((128, 128), (64, 128), (64, 64),
                                      (32, 64))
    assert _const(ATT, "ATT_SCORE_WARPS") == 8
    assert _const(ATT, "CTX_THREADS") == 64
    assert _const(SPLIT, "RING") == decode_step.SPLIT_RING
    assert _const(SPLIT, "CHUNK_ROWS") == decode_step.SPLIT_CHUNK_ROWS
    assert _const(SPLIT, "SLAB_F4") == decode_step.SPLIT_SLAB_F4
    assert _const(SPLIT, "SPLIT_SMEM_LIMIT") == cuda_lib.SMEM_LIMIT
    assert _const(SCAN, "D1_PCH") == att_scan.D1_PCH
    assert _const(SCAN, "SMEM_MAX") == cuda_lib.SMEM_LIMIT


def test_the_gemm_smem_mirror_follows_the_source():
    """A product block holds two k tiles (the one read, the one written)
    of its rows, k-major (8 x BM + 4 floats), and of the weight (8 x BN):
    16,640 bytes at 128 x 128, down to 6,400 at 32 x 64, static shared
    memory."""
    assert "return sizeof(float) * 2 * GEMM_BK *" in STEP
    assert "((size_t)gemm_bm(cfg) + 4 + (size_t)gemm_bn(cfg));" in STEP
    assert "__shared__ __align__(16) float As[2][GEMM_BK][LDA];" in STEP
    assert "__shared__ __align__(16) float Ws[2][GEMM_BK][BN];" in STEP
    assert [decode_step.gemm_smem(c) for c in range(4)] == [16640, 12544,
                                                            8448, 6400]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h", PLAN_H)
@pytest.mark.parametrize("rows", PLAN_ROWS)
def test_the_many_row_plan_at_every_row_count_and_width(kind, h, rows):
    """Every launch of the step fits a block (threads, shared memory) and
    the grid; each product's blocks cover its (row, column) outputs once
    (row tiles x column tiles x segments at the chosen tile), its tile the
    least busiest-SM load; so each weight tile is read once per tile of
    rows, ceil(R / BM) times a step."""
    k = 5 if rows % 5 == 0 else 1
    plan = _plan(kind, rows, h, ktop=5, k=k)
    hp = widths.quad(h)
    products = {"k1": ["pre", "style", "z", "logits"],
                "factored": ["pre", "v", "style", "z", "logits"],
                "lstm": ["pre", "z", "logits"]}[kind]
    assert [n for n, t, *_ in plan if t] == products
    jobs = {"pre": ([(4 * hp, 1), (4 * hp, 1)] if kind == "k1" else
                    [(A, 1), (FS, 1), (4 * hp, 1)]),
            "v": [(4 * hp, 1)], "style": [(hp, 4)],
            "z": [(hp, 4)] if kind != "lstm" else [(4 * hp, 1)],
            "logits": [(V, 1)]}
    for name, tile, blocks, threads, smem in plan:
        assert 1 <= blocks < 2 ** 31
        assert 32 <= threads <= 1024 and threads % 32 == 0
        assert 0 <= smem <= cuda_lib.SMEM_LIMIT
        if tile is None:
            continue
        cfg = decode_step.GEMM_TILES.index(tile)
        assert cfg == decode_step.gemm_pick(rows, jobs[name])
        bm, bn = tile
        assert threads == bm * bn // 64 and smem == decode_step.gemm_smem(cfg)
        assert blocks == sum(-(-rows // bm) * s * -(-n // bn)
                             for n, s in jobs[name])
        costs = [-(-decode_step.gemm_blocks(c, rows, jobs[name]) // 132)
                 * (tb[0] * tb[1] + 8 * (tb[0] + tb[1]))
                 for c, tb in enumerate(decode_step.GEMM_TILES)]
        assert costs[cfg] == min(costs) and costs.index(min(costs)) == cfg
    names = [n for n, *_ in plan]
    assert names[-2:] == ["tile_partials", "merge"]
    assert "gates" in names
    if kind != "k1":
        assert names[1:3] == ["scores", "context"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows,hw", [(320, 2048), (320, 1024), (1024, 1024),
                                     (16384, 512), (16384, 2048), (9, 2048)])
def test_the_pick_fills_the_card(kind, rows, hw):
    """At R = 320 every product launch has more blocks than the card's
    132 SMs (smaller tiles where 128 x 128 would leave SMs idle); at 16,384
    rows every product takes 128 x 128, the tile that copies the fewest
    bytes; at 9 rows (one row tile) the 32 x 64 tile."""
    plan = [(n, t, b) for n, t, b, *_ in _plan(kind, rows, hw) if t]
    if rows == 320:
        assert all(b >= 132 for _, _, b in plan), plan
    if rows == 16384:
        assert all(t == (128, 128) for _, t, _ in plan), plan
    if rows == 9:
        assert all(t == (32, 64) for _, t, _ in plan), plan
    if (rows, hw, kind) == (1024, 1024, "k1"):
        assert all(t == (128, 128) for _, t, _ in plan), plan


@pytest.mark.parametrize("ktop", [1, 5, 8, 9, 20, 256, 257, 300])
def test_the_reduce_follows_the_top_k(ktop):
    """k <= 8: the tile partials (a warp a row and 256-wide tile) and the
    merge; above, the wide reduce, a block a row; the work buffer holds the
    partials, or above 256 the survivors."""
    plan = _plan("k1", 320, 512, ktop=ktop)
    names = [n for n, *_ in plan]
    tiles = 320 * V // 256
    if ktop <= 8:
        assert names[-2:] == ["tile_partials", "merge"]
        assert plan[-2][2] == tiles // 8
    else:
        assert names[-1] == "wide_reduce" and plan[-1][2] == 320
    floats = decode_step.step_work_floats("k1", 320, E, 512, 512, V, ktop)
    base = 320 * (4 * 512 * 4 + V)
    extra = {True: 2 * 320 * 32 + 2 * 320 * 32 * ktop}.get(ktop <= 8, 0)
    if ktop > 256:
        extra = 2 * 320 * ktop
    assert floats == base + extra


@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_the_work_buffer_mirror_at_ragged_widths(kind):
    """Each plane starts at a multiple of 4 floats (16 bytes): att2, the
    gate pre-activation, the scores (P = 197), x (E + FS = 2349 -> 2352),
    the h product, (factored) v and s, z, the logits, the partials."""
    rows, e, f, h, v, a, p, fs = 15, 301, 44, 48, 8192, 512, 197, 2048
    q = lambda n: (n + 3) & ~3  # noqa: E731
    planes = [rows * a, rows * fs, rows * p, rows * 2352, rows * 4 * h]
    if kind == "factored":
        planes += [rows * 4 * f] * 2
    planes += [rows * 4 * h, rows * v, rows * 32, rows * 32,
               rows * 32 * 5, rows * 32 * 5]
    assert decode_step.step_work_floats(kind, rows, e, f, h, v, 5, a, p,
                                        fs) == sum(q(n) for n in planes)


@pytest.mark.parametrize("e_in,f,h", EARLIER)
def test_every_earlier_shape_has_a_many_row_plan(e_in, f, h):
    """Every shape the row-tiled launches ran has a plan at 320 rows, each
    launch within a block's shared memory."""
    kind = "k1" if e_in <= 300 else "factored"
    e = e_in if kind == "k1" else e_in - FS if e_in > FS else 30
    fs = 0 if kind == "k1" else e_in - e
    extra = {} if kind == "k1" else dict(a=A, p=P, fs=fs, k=5)
    for name, tile, blocks, threads, smem in decode_step.step_plan(
            kind, 320, e, f, h, V, 5, **extra):
        assert smem <= cuda_lib.SMEM_LIMIT and blocks >= 1


@pytest.mark.parametrize("hw", [773, 2612, 3700, 6200, 8192])
def test_the_many_row_path_takes_any_width(hw):
    """The row-tiled cell gave up rows past H = 772 (K1) and refused one
    row near H = 6,000, its head near 2,600; the many-row products hold
    no row of h whole, so every width plans within a block."""
    for kind in KINDS:
        for _, _, _, _, smem in _plan(kind, 320, hw, ktop=20):
            assert smem <= cuda_lib.SMEM_LIMIT


@pytest.mark.parametrize("a,p,match", [
    (8192, 7300, r"K6: the attention launches' 8 rows at A=8192, P=7300"),
    (512, 7300, r"K6: the attention launches' 8 rows at A=512, P=7300"),
])
def test_past_the_new_bounds_the_check_names_the_launch(a, p, match):
    """K6's context launch holds a group's 8 score rows (8 P): P up to
    7,264; past that the check names the launch.  Its scores launch holds
    their 8 att2 rows (8 A floats) whole up to A = 7,264 and stages them
    in column pieces of 7,168 past it, so any A passes.  One row a group
    (k = 1) holds 8 times more."""
    with pytest.raises(ValueError, match=match):
        att_decode_step.check_attend("K6", 8, a, p)
    att_decode_step.check_attend("K6", 1, a, p)
    att_decode_step.check_attend("K6", 8, 7264, 7264)
    for wide in (7268, 8192, 12000, 100000):
        att_decode_step.check_attend("K6", 8, wide, 196)
        assert att_decode_step.scores_cols(8, wide) == 7168
    assert att_decode_step.attend_smem(8, 7264, 196) == cuda_lib.SMEM_LIMIT
    assert att_decode_step.attend_smem(8, 8192, 196) == 4 * 8 * 7168
    assert att_decode_step.scores_cols(8, 7264) == 7264


def test_the_split_path_keeps_every_earlier_shape():
    """The serial shapes (one image, k <= 8) ran the column-split path at
    every width phases 4-26 used, and still do."""
    for rows in (1, 5, 8):
        for e, f, h in ((300, 512, 512), (30, 48, 64), (16, 32, 32)):
            assert decode_step.split_k1_smem(rows, e, f, h) <= \
                cuda_lib.SMEM_LIMIT
            for fact in (True, False):
                assert att_decode_step.split_att_smem(
                    fact, rows, e, f if fact else h, h, 512, 196,
                    2048) <= cuda_lib.SMEM_LIMIT


@pytest.mark.parametrize("rows,fits", [(5, True), (8, False)])
def test_the_split_path_hands_wide_cells_to_the_row_tiled_path(rows, fits):
    """At F = H = 2048 the factored gates launch holds four copies of R
    rows of s: 5 rows fit, 8 do not, and the wrappers then take the
    row-tiled path (the same bits a row); the LSTM cell fits both."""
    smem = decode_step.split_k1_smem(rows, 300, 2048, 2048)
    assert (smem <= cuda_lib.SMEM_LIMIT) == fits
    assert (att_decode_step.split_att_smem(True, rows, 300, 2048, 2048, 512,
                                           196, 2048)
            <= cuda_lib.SMEM_LIMIT) == fits
    assert att_decode_step.split_att_smem(False, rows, 300, 2048, 2048, 512,
                                          196, 2048) <= cuda_lib.SMEM_LIMIT


def test_the_split_slab_mirror_follows_the_source():
    """``split_slab_smem`` is ``slab_smem_floats``: the ring (at most 6
    chunks of 128 weight rows x 16 columns), the input rows padded to 32
    plus 4, a copy a gate where the gates read their own segments, and
    the gates' z exchange."""
    assert "const int slots = nch < RING ? nch : RING;" in SPLIT
    assert "return slots * CHUNK_FLOATS + n_a * R * split_kp(J.K) +" in SPLIT
    assert decode_step.split_slab_smem(100, 1, False, 3) == 4 * (
        2048 + 3 * 132)
    assert decode_step.split_slab_smem(1000, 4, True, 5) == 4 * (
        6 * 2048 + 4 * 5 * 1028 + 16 * 5)


# (T, A) of every K5 backward phases 4-26 ran: T = 25 at the flagship, 42
# from the CLI's caption length, the card tests' narrow shapes
EARLIER_SCANS = [(25, 512), (42, 512), (22, 512), (25, 20), (3, 20),
                 (4, 8), (25, 1024), (25, 512 + 4), (62, 512)]


@pytest.mark.parametrize("t,a", EARLIER_SCANS)
def test_every_earlier_d_att1_pass_keeps_one_column_block(t, a):
    assert att_scan.datt1_plan(t, a) == (a, 1)


@pytest.mark.parametrize("t,a,want", [
    (42, 2048, (1024, 2)), (62, 1024, (512, 2)), (60, 1024, (512, 2)),
    (28, 2048, (1024, 2)), (27, 2048, (2048, 1)), (55, 1024, (1024, 1)),
    (56, 1024, (512, 2)), (108, 512, (256, 2)), (107, 512, (512, 1)),
    (42, 8192, (1172, 7)), (1816, 4, (4, 1)), (1816, 512, (4, 128)),
])
def test_the_d_att1_pass_splits_a_into_column_blocks_that_fit(t, a, want):
    cols, n = att_scan.datt1_plan(t, a)
    assert (cols, n) == want
    assert cols % 4 == 0 or n == 1
    assert 4 * t * (cols + att_scan.D1_PCH) <= cuda_lib.SMEM_LIMIT
    assert (n - 1) * cols < a <= n * cols


def test_past_1816_steps_the_d_att1_pass_raises():
    """Past T = 1,816 not even 4 columns of the (T, A) plane fit a block:
    the pass no longer raises but takes a column a thread (A_c = min(A,
    256)) and the steps in chunks whose plane and d_e fit; up to 1,816
    every plan keeps all T steps."""
    assert att_scan.datt1_plan(1817, 4) == (4, 1)
    assert att_scan.datt1_steps(1817, 4) == 1816
    assert att_scan.datt1_steps(1816, 512) == 1816
    for t in (1817, 1900, 4000, 20000):
        for a in (4, 20, 512, 8192):
            cols, n = att_scan.datt1_plan(t, a)
            steps = att_scan.datt1_steps(t, a)
            assert cols == min(a, att_scan.D1_THREADS)
            assert (n - 1) * cols < a <= n * cols
            assert 1 <= steps < t
            assert 4 * steps * (cols + att_scan.D1_PCH) <= \
                cuda_lib.SMEM_LIMIT
            assert 4 * (steps + 1) * (cols + att_scan.D1_PCH) > \
                cuda_lib.SMEM_LIMIT


@pytest.mark.parametrize("t,a,want", [
    (1900, 512, (256, 2, 204)), (4000, 512, (256, 2, 204)),
    (1900, 20, (20, 1, 1210)), (4000, 8192, (256, 32, 204)),
])
def test_the_d_att1_pass_chunks_steps_past_1816(t, a, want):
    assert (*att_scan.datt1_plan(t, a), att_scan.datt1_steps(t, a)) == want


@pytest.mark.parametrize("t,steps", [(9, 4), (13, 5), (7, 1), (6, 6)])
def test_the_chunked_d_att1_chain_is_the_unchunked_one_bit_for_bit(t, steps):
    """Each (position, column) sum of the d_att1 pass is one chain over
    the steps in reverse order; cutting the steps into chunks carries it
    from chunk to chunk, so d_att1 is the same bits (the CPU model
    ``att_scan.datt1_chain``, float32 add by add); full_w's sum is taken
    in (chunk, position, step) order there, within float32 rounding of
    the one-chunk order."""
    rng = np.random.default_rng(t * 100 + steps)
    pre = torch.from_numpy(rng.standard_normal((t, 5, 12)).astype(
        np.float32))
    de = torch.from_numpy(rng.standard_normal((t, 5)).astype(np.float32))
    fw = torch.from_numpy(rng.standard_normal(12).astype(np.float32))
    d1, w1 = att_scan.datt1_chain(pre, de, fw, t)
    d2, w2 = att_scan.datt1_chain(pre, de, fw, steps)
    assert torch.equal(d1, d2)
    want = (np.maximum(pre.double().numpy(), 0) * de.double().numpy()[
        :, :, None]).sum((0, 1))
    np.testing.assert_allclose(w2.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w1.numpy(), want, rtol=1e-5, atol=1e-5)
    dwant = (np.where(pre.numpy() > 0, 1.0, 0.0) * de.double().numpy()[
        :, :, None]).sum(0) * fw.double().numpy()
    np.testing.assert_allclose(d1.numpy(), dwant, rtol=1e-5, atol=1e-5)
