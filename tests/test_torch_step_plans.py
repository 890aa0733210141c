"""The host side of the step and attention-training launches past one
block's shared memory, no JAX: the mirrors of ``csrc/step_kernels.cuh``'s
``cell_rows`` (K1's and K6's row-tiled cell launch: 8 rows a block where
their planes fit, else 4, 2 or 1), of ``csrc/split_step.cuh``'s shared
memory (the column-split launches, which hand a shape they do not hold to
the row-tiled path) and of ``csrc/att_scan.cu``'s ``datt1_cols`` (K5's
d_att1 pass, split over column blocks of A past its (T, A) plane).  Every
shape the earlier launches took keeps their plan: 8 rows a cell block,
the split path, one column block.  Past the new bounds the checks raise,
naming the launch.  The mirrors are held to the CUDA sources' constants
here and to the libraries themselves when they load on the card.
"""

import re
from pathlib import Path

import pytest

from icee_tpu_torch.ops import att_decode_step, att_scan, cuda_lib
from icee_tpu_torch.ops import decode_step

CSRC = Path(decode_step.__file__).resolve().parents[1] / "csrc"
STEP = (CSRC / "step_kernels.cuh").read_text()
SPLIT = (CSRC / "split_step.cuh").read_text()
SCAN = (CSRC / "att_scan.cu").read_text()

# (E_in, F, H) of every K1 / K6 row-tiled launch the card ran before:
# the flagship (K1 E = 300, K6 E + FS = 2348), ragged widths padded to 4,
# the card tests' narrow ones
EARLIER = [(300, 512, 512), (2348, 512, 512), (300, 512, 512),
           (300 + 2048, 512, 512), (30, 48, 64), (300, 64, 32),
           (16, 32, 32), (30 + 64, 48, 48), (30 + 64, 32, 48),
           (300, 772, 772), (2348, 544, 544)]


def _const(text: str, name: str) -> int:
    return int(re.search(r"constexpr (?:int|size_t) %s = (\d+);" % name,
                         text).group(1))


def test_the_mirrors_constants_are_the_kernels():
    assert _const(STEP, "CELL_ROWS") == decode_step.CELL_ROWS
    assert _const(STEP, "HEAD_ROWS") == decode_step.HEAD_ROWS
    assert _const(STEP, "HEAD_TILES") == decode_step.HEAD_TILES
    assert _const(STEP, "STEP_SMEM_MAX") == cuda_lib.SMEM_LIMIT
    assert _const(SPLIT, "RING") == decode_step.SPLIT_RING
    assert _const(SPLIT, "CHUNK_ROWS") == decode_step.SPLIT_CHUNK_ROWS
    assert _const(SPLIT, "SLAB_F4") == decode_step.SPLIT_SLAB_F4
    assert _const(SPLIT, "SPLIT_SMEM_LIMIT") == cuda_lib.SMEM_LIMIT
    assert _const(SCAN, "D1_PCH") == att_scan.D1_PCH
    assert _const(SCAN, "SMEM_MAX") == cuda_lib.SMEM_LIMIT


@pytest.mark.parametrize("e_in,f,h", EARLIER)
def test_every_earlier_cell_launch_keeps_8_rows(e_in, f, h):
    assert decode_step.cell_rows(e_in, f, h) == 8
    assert decode_step.cell_smem(8, e_in, f, h) <= cuda_lib.SMEM_LIMIT
    decode_step.check_tiled("K1", e_in, f, h, 5)


@pytest.mark.parametrize("e_in,first", [(300, 773), (2348, 545)])
def test_the_cell_launch_gives_up_8_rows_where_they_no_longer_fit(e_in,
                                                                  first):
    """K1 (E = 300) holds 8 rows to H = 772, K6 (E + FS = 2348) to 544;
    past that 4 a block (widths padded to 4: the next is first + 3)."""
    last = first - 1
    assert decode_step.cell_rows(e_in, last, last) == 8
    assert decode_step.cell_rows(e_in, first + 3, first + 3) == 4


@pytest.mark.parametrize("e_in", [300, 2348])
@pytest.mark.parametrize("hw,rows", [(1024, 4), (2048, 2)])
def test_the_training_widths_take_4_and_2_rows(e_in, hw, rows):
    """At H = F = 1024 a block holds 4 rows, at 2048 two, for K1 and K6
    alike (4 (E_in + 9 H) bytes a row), and the head launch holds its 16
    rows of h at both widths and either top-k."""
    assert decode_step.cell_rows(e_in, hw, hw) == rows
    assert decode_step.cell_smem(rows, e_in, hw, hw) <= cuda_lib.SMEM_LIMIT
    assert decode_step.cell_smem(2 * rows, e_in, hw, hw) > \
        cuda_lib.SMEM_LIMIT
    for ktop in (5, 20):
        decode_step.check_tiled("K6", e_in, hw, hw, ktop)
    assert att_decode_step.tiled_step_smem(e_in, hw, hw, 0) == \
        decode_step.cell_smem(rows, e_in, hw, hw)


@pytest.mark.parametrize("e_in,f,h,ktop,match", [
    (2348, 6200, 6200, 20, r"K6: the cell launch does not hold one row at "
     r"E_in=2348, F=6200, H=6200"),
    (300, 2700, 2700, 5, r"K1: the head launch's 16 rows at H=2700, ktop=5"),
    (300, 3700, 3700, 20, r"K1: the head launch's 16 rows at H=3700"),
])
def test_past_the_new_bounds_the_check_names_the_launch(e_in, f, h, ktop,
                                                        match):
    with pytest.raises(ValueError, match=match):
        decode_step.check_tiled(e_in == 300 and "K1" or "K6", e_in, f, h,
                                ktop)


def test_the_head_launch_holds_2048_and_stops_near_2600():
    for ktop in (5, 20):
        assert decode_step.head_smem(2048, ktop) <= cuda_lib.SMEM_LIMIT
    assert decode_step.head_smem(2608, 5) <= cuda_lib.SMEM_LIMIT
    assert decode_step.head_smem(2612, 5) > cuda_lib.SMEM_LIMIT
    assert decode_step.head_smem(2612, 20) <= cuda_lib.SMEM_LIMIT


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
    with pytest.raises(ValueError, match=r"K5\): T=1817 steps"):
        att_scan.datt1_plan(1817, 4)
