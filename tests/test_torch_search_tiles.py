"""The tile geometry of K2's and K7's product stages (``csrc/grid_beam.cuh``
run_tiles; planned by ``icee_tpu_torch/ops/beam.py::plan_tiles``): the
host's mirror of what the kernel runs where a step's live rows reach a
stage's threshold.  Every (live row, column) of every tiled stage must be
one tile unit's, once, at every live-row count; a gate tile must hold the
same columns of all four gates, and the two lanes of a warp that share
them the four gates between them; a tile's chunk must fit a ring slot; the
plan's ctypes struct must carry each stage's tile slabs, their place in
the slab table and the threshold; the geometry must change exactly at the
threshold, as the kernel's ``stage_geo`` reads it, and the cost model must
put the tiles at or below the slabs from there; and the tile plans of the
shapes the grid tests plan must be the ones recorded here.  The kernels run on
the card (``scripts/search_turns.py``, ``chip_smoke.py``).
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest

from icee_tpu_torch.ops import att_beam, beam
from icee_tpu_torch.ops.att_beam import att_grid_plan
from icee_tpu_torch.ops.beam import (SLOT_FLOATS, TBM, TBN, TILE_KT,
                                     TilePlan, grid_plan, stage_geo,
                                     tile_chunk_floats, tile_units)

CSRC = Path(beam.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "grid_beam.cuh").read_text()

# (kernel, plan arguments): K2 at the turns script's shapes and a ragged
# one, K7 likewise (its per-image stage keeps its slabs)
PLANS = [
    ("k2", ("factored", 300, 512, 512, 8192, 20, 51, 40, 132)),
    ("k2", ("factored", 300, 512, 512, 8192, 300, 3, 20, 132)),
    ("k2", ("factored", 300, 512, 512, 8192, 2048, 1, 4, 132)),
    ("k2", ("factored", 30, 40, 48, 516, 8, 128, 10, 7)),
    ("k2", ("lstm", 300, 512, 512, 8192, 20, 51, 40, 132)),
    ("k2", ("lstm", 300, 512, 512, 8192, 2048, 1, 4, 132)),
    ("k2", ("lstm", 30, 48, 48, 516, 8, 128, 10, 7)),
    ("k7", ("factored", 300, 512, 512, 8192, 512, 196, 2048, 20, 51, 40,
            132)),
    ("k7", ("factored", 300, 512, 512, 8192, 512, 196, 2048, 2048, 1, 4,
            132)),
    ("k7", ("lstm", 300, 512, 512, 8192, 512, 196, 2048, 20, 51, 40, 132)),
    ("k7", ("lstm", 30, 48, 48, 516, 16, 49, 64, 8, 128, 10, 7)),
]


def _plan(kernel, args):
    return grid_plan(*args) if kernel == "k2" else att_grid_plan(*args)


def _forced(stage):
    """The stage's tiles from one live row."""
    return TilePlan(beam.tile_slabs(stage.jobs), 1)


def _slab_cells(job, slab):
    """The output columns a tile slab covers: its segment's, or its
    columns of each of the four gates."""
    _, seg, c0, width = slab
    segs = range(4) if job.gates else (seg,)
    return [g * job.segw + c for g in segs for c in range(c0, c0 + width)]


@pytest.mark.parametrize("kernel,args", PLANS,
                         ids=lambda x: x if isinstance(x, str) else
                         "-".join(map(str, x)))
def test_tiles_cover_each_live_row_and_column_once(kernel, args):
    plan = _plan(kernel, args)
    counts = {1, 2, 7, 8, 31, 127, 128, 129, 255, 256, 257, 300, 513,
              plan.rows}
    for si, st in enumerate(plan.stages):
        if plan.tiles[si] == TilePlan():
            continue
        tiles = _forced(st)
        width = {ji: j.nseg * j.segw for ji, j in enumerate(st.jobs)}
        for n in sorted(c for c in counts if c <= plan.rows):
            seen = {ji: np.zeros((n, w), np.int32) for ji, w in width.items()}
            units = tile_units(tiles, n)
            for slab, i0, nr in units:
                assert 1 <= nr <= TBM
                job = st.jobs[slab[0]]
                for col in _slab_cells(job, slab):
                    seen[slab[0]][i0:i0 + nr, col] += 1
            assert all((s == 1).all() for s in seen.values()), (si, n)
            # a slab's row tiles are adjacent in the unit order
            order = [u[0] for u in units]
            assert order == sorted(order, key=tiles.slabs.index)


@pytest.mark.parametrize("kernel,args", PLANS,
                         ids=lambda x: x if isinstance(x, str) else
                         "-".join(map(str, x)))
def test_a_gate_tile_holds_the_same_columns_of_all_four_gates(kernel, args):
    plan = _plan(kernel, args)
    gate_stages = [i for i, st in enumerate(plan.stages)
                   if any(j.gates for j in st.jobs)]
    assert gate_stages
    for si in gate_stages:
        st = plan.stages[si]
        assert len(st.jobs) == 1   # the tiles run the cell on one job
        job = st.jobs[0]
        for slab in beam.tile_slabs(st.jobs):
            _, seg, c0, width = slab
            assert seg == 0 and 0 < width <= TBN // 4 and width % 4 == 0
            # the kernel's lanes (tile_col): column quad q of lane tx is
            # gate 2 q + tx / 8 at columns c0 + 4 (tx % 8) + j, so lanes tx
            # and tx ^ 8 hold the four gates of the same four columns
            for tx in range(8):
                held = {}
                for lane in (tx, tx ^ 8):
                    for q in range(2):
                        g = 2 * q + lane // 8
                        held.setdefault(c0 + 4 * (tx % 8), set()).add(g)
                assert held == {c0 + 4 * tx: {0, 1, 2, 3}}
        cols = sorted(c for slab in beam.tile_slabs(st.jobs)
                      for c in _slab_cells(job, slab))
        assert cols == list(range(4 * job.segw))
    src = SOURCE[SOURCE.index("int tile_col("):]
    assert "(2 * q + (tx >> 3)) * J.segw + x.slab.z + cl" in src
    assert "const int cl = 4 * (tx & 7);" in src


def test_a_tile_chunk_fits_a_tile_slot_as_the_kernel_lays_it_out():
    cfg = SOURCE[SOURCE.index("struct TileCfg {"):]
    cfg = cfg[:cfg.index("};")]
    assert "LDA = KT;" in cfg and "SS = TBM * LDA + 8;" in cfg
    assert "KT = SETS == 4 ? 12 : 36;" in cfg
    assert TILE_KT == {1: 36, 4: 12}
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", SOURCE))
    assert int(consts["TSLOTS"]) == beam.TILE_SLOTS
    assert consts["TSLOT_FLOATS"] == "RING_FLOATS / TSLOTS"
    slot = beam.RING_FLOATS // beam.TILE_SLOTS
    for sets, kt in TILE_KT.items():
        floats = kt * TBN + sets * (TBM * kt + 8)
        assert floats == tile_chunk_floats(sets) <= slot
        # a set's skew puts the four sets' rows 8 banks apart, a warp's two
        # halves (4 rows apart) 16 banks apart
        assert (TBM * kt + 8) % 32 == 8 and (4 * kt) % 32 == 16
        assert kt % 4 == 0 and slot % 4 == 0   # 16-byte copies and loads
    for name, val in (("TBM", TBM), ("TBN", TBN)):
        assert re.search(r"constexpr int %s = (\d+);" % name,
                         SOURCE).group(1) == str(val)
    # a warp: 8 rows (two halves of 4) by 16 lanes of 2 column quads
    assert TBM == 8 * (beam.THREADS // 32) and TBN == 2 * 4 * 16


@pytest.mark.parametrize("kernel,args", PLANS,
                         ids=lambda x: x if isinstance(x, str) else
                         "-".join(map(str, x)))
def test_the_ctypes_plan_carries_the_tiles(kernel, args):
    plan = _plan(kernel, args)
    c = (beam._c_plan(plan, 1, 2, True) if kernel == "k2"
         else att_beam._c_plan(plan, 1, 2))
    table = plan.slab_table().tolist()
    for i, t in enumerate(plan.tiles):
        assert (c.t_slabs[i], c.t_min[i]) == (len(t.slabs), t.min_rows)
        first = c.t_slab0[i]
        assert table[first:first + len(t.slabs)] == [list(s) for s in t.slabs]
        assert (t.min_rows == 0) == (t.slabs == ())
        # no tiles for the LSTM cell's two chains, nor a per-image stage
        st = plan.stages[i]
        if kernel == "k2" and plan.cell == "lstm" and st.jobs[0].gates:
            assert t == TilePlan()
    if kernel == "k7":
        assert plan.tiles[att_beam.CTX_STAGE] == TilePlan()
    for i in range(len(plan.tiles), beam.MAX_STAGES):
        assert (c.t_slabs[i], c.t_min[i]) == (0, 0)


@pytest.mark.parametrize("kernel,args", PLANS,
                         ids=lambda x: x if isinstance(x, str) else
                         "-".join(map(str, x)))
def test_the_tiles_are_taken_exactly_from_the_threshold(kernel, args):
    plan = _plan(kernel, args)
    for t in plan.tiles:
        for n in range(1, plan.rows + 1):
            assert stage_geo(t, n) == (t.min_rows > 0 and n >= t.min_rows)
    geo = SOURCE[SOURCE.index("bool stage_geo(const Stage& S, int n)"):]
    geo = geo[:geo.index("\n}")]
    assert "return S.tmin > 0 && n >= S.tmin;" in geo
    # the launch runs the kernel with the tiles only where a stage has them
    for name in ("beam.cu", "att_beam.cu"):
        assert "has_tiles(p)" in (CSRC / name).read_text()


@pytest.mark.parametrize("sets", [1, 4])
def test_the_cost_model_puts_the_tiles_below_the_slabs_past_them(sets):
    jobs = beam.stage_jobs("factored", 300, 512, 512, 8192)
    for rows in (40, 260, 383, 384, 900, 1020, 2048):
        for grid in (8, 132):
            for js in jobs:
                st = beam.plan_stage(js, grid, rows)
                slabs = beam.tile_slabs(js)
                least = beam.tile_min_rows(st, slabs, sets, grid, rows)
                if rows < beam.TILE_LAUNCH_MIN:
                    assert least == 0
                    continue
                n = np.arange(1, rows + 1)
                slab, tile = beam.stage_us(st, slabs, sets, grid, n)
                good = tile <= slab
                if not least:
                    assert not good[-1]
                    continue
                assert good[least - 1:].all()
                assert least == 1 or not good[least - 2]


def _k2_cases():
    """The shapes of test_torch_beam_grid.py's narrow digest."""
    for cell in ("factored", "lstm"):
        for k in (1, 2, 5, 8, 9, 20, 64, 256):
            for v in (516, 8192, 8800, 40000):
                for n_img in sorted({1, 4, beam.MAX_ROWS // k}):
                    for max_seq in (0, 20, 40):
                        for grid in (1, 8, 132):
                            yield (cell, 300, 512, 512, v, k, n_img,
                                   max_seq, grid)


def _k7_cases():
    """The shapes of test_torch_att_beam_grid.py's narrow digest."""
    for kind in ("factored", "lstm"):
        for k in (1, 5, 8, 9, 20, 256):
            for v in (516, 8192):
                for n_img in sorted({1, beam.MAX_ROWS // k}):
                    for grid in (3, 132):
                        yield (kind, 300, 512, 512, v, 512, 196, 2048, k,
                               n_img, 20, grid)


# sha256 of the tile plans (each stage's TilePlan repr) of the grid tests'
# narrow shapes, K2's then K7's
TILE_PLANS = (
    "42ef2d63f8f33189492ea9b5de02f3a14742ecacbcf1f9cf8d8467c521e41e82",
    "b188881ce80969b33474cd3efb33a7d54aa3a0be7295ae25109a49e27bd0edec")


def _digest(plans) -> str:
    h = hashlib.sha256()
    for plan in plans:
        h.update(repr(plan.tiles).encode())
    return h.hexdigest()


def test_the_tile_plans_are_the_recorded_ones():
    assert _digest(grid_plan(*a) for a in _k2_cases()) == TILE_PLANS[0]
    assert _digest(att_grid_plan(*a) for a in _k7_cases()) == TILE_PLANS[1]
