"""The host side of K2's whole-card search (``icee_tpu_torch/ops/beam.py``):
the launch plan that ``csrc/beam.cu`` reads.  Every stage's column slabs
must cover each output column of each of its products once and in order
(a ragged vocabulary, F != H, grids of 1 to 132 blocks); the slabs and row
blocks must fit the kernel's chunk slots; the scratch regions must be
disjoint, aligned and of the sizes the kernel indexes, at 1, 8 and 64
images (as many as ``MAX_ROWS`` rows hold) and k = 1, 5, 8 and the wide
paths' 9, 20, 64, 256, and past one block (``SEL_SCAN``: k = 257 up to V,
an image of more than ``MAX_ROWS`` rows; k <= 8 at V = 100,000); a batch
must split into launches of at most ``MAX_ROWS`` rows, or one image; the
beam tail's scratch must fit the ring; every plan the narrower paths made
before is unchanged; and the plan and the wrapper must raise on what the
kernel does not take.  The ctypes
mirror of the kernel's ``GridPlan`` and its geometry constants are held
against the CUDA sources' text (``csrc/beam.cu``, the
``csrc/grid_beam.cuh`` it shares with K7, ``csrc/wide_topk.cuh`` and
``csrc/decode_common.cuh``).
The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch import bridge
from icee_tpu_torch.ops import beam
from icee_tpu_torch.ops.beam import (K_MAX, K_WIDE, KC, KCP, MAX_BR, MAX_K,
                                     MAX_ROWS, SEL_NARROW, SEL_SCAN,
                                     SEL_WIDE, SLOT_FLOATS, THREADS,
                                     TOPK_FLOATS, grid_plan, launch_chunks,
                                     mega_beam_decode_steps, slab_columns)

CSRC = Path(beam.__file__).resolve().parents[1] / "csrc"
# the kernel and the machinery it shares with K7
SOURCE = "".join((CSRC / n).read_text() for n in ("beam.cu",
                                                  "grid_beam.cuh",
                                                  "wide_topk.cuh",
                                                  "decode_common.cuh"))
WIDE_KS = [9, 20, 64, 256]   # the wide paths' widths (k > K_MAX)
SHAPES = [  # (cell, E, F, H, V)
    ("factored", 300, 512, 512, 8192),   # flagship
    ("factored", 30, 40, 48, 516),       # ragged V, F != H, E % 4 != 0
    ("lstm", 300, 512, 512, 8192),
    ("lstm", 30, 48, 48, 516),
]


@pytest.mark.parametrize("grid", [1, 3, 8, 132])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_slabs_cover_each_column_once_and_in_order(shape, grid):
    cell, e, f, h, v = shape
    plan = grid_plan(cell, e, f, h, v, 5, 8, 40, grid)
    want = {"v": 4 * f, "hw": 4 * h, "s": 4 * f, "z": 4 * h,
            "gates": 4 * h, "logits": v}
    names = [j.name for st in plan.stages for j in st.jobs]
    assert names == (["v", "hw", "s", "z", "logits"] if cell == "factored"
                     else ["gates", "logits"])
    for st in plan.stages:
        for ji, job in enumerate(st.jobs):
            cols = slab_columns(st, ji)
            if job.gates:   # gate by gate within a slab, slabs in order
                assert sorted(cols) == list(range(want[job.name]))
                per_gate = [[c - g * job.segw for c in cols
                             if g * job.segw <= c < (g + 1) * job.segw]
                            for g in range(4)]
                assert all(p == list(range(job.segw)) for p in per_gate)
            else:
                assert cols == list(range(want[job.name]))
        # each slab is a whole number of column quads inside its segment
        for ji, seg, c0, width in st.slabs:
            job = st.jobs[ji]
            assert c0 % 4 == 0 and width % 4 == 0 and width > 0
            assert c0 + width <= job.segw and 0 <= seg < job.nseg
            assert width <= (st.cw // 4 if job.gates else st.cw)
    # the table: every stage's slabs in turn, then every stage's tile slabs
    table = plan.slab_table()
    rows = [s for st in plan.stages for s in st.slabs]
    rows += [s for t in plan.tiles for s in t.slabs]
    assert table.shape == (len(rows), 4)
    assert table.tolist() == [list(s) for s in rows]
    assert table.dtype == np.int32


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_stages_fit_the_kernels_slots_and_threads(shape):
    cell, e, f, h, v = shape
    for grid in (1, 2, 132):
        for st in grid_plan(cell, e, f, h, v, 8, 64, 40, grid).stages:
            lanes = THREADS // (st.cw // 4)
            sets = max(j.sets for j in st.jobs)
            assert st.cw in (16, 32, 64)
            assert 1 <= st.br <= min(MAX_BR, 2 * lanes)
            assert KC * st.cw + sets * st.br * KCP <= SLOT_FLOATS
            assert sets * st.br <= beam.MAX_UNIT_ROWS  # two rows a copier
            # a gate unit's z exchange: four gates x br rows x cw / 4
            assert st.br * st.cw <= 64 * 64
    # at flagship width on 132 SMs every stage is one round of slabs, so a
    # one-image step runs each product once per block
    for cell in ("factored", "lstm"):
        for st in grid_plan(cell, 300, 512, 512, 8192, 5, 1, 40, 132).stages:
            assert len(st.slabs) <= 132


@pytest.mark.parametrize("k", [1, 5, 8] + WIDE_KS)
@pytest.mark.parametrize("n_img", [1, 8, 64])
@pytest.mark.parametrize("cell", ["factored", "lstm"])
def test_scratch_regions_are_disjoint_aligned_and_sized(cell, n_img, k):
    """Above K_MAX pv and pi hold each row's top-k, pm and pse go unused
    and the sequences take two planes (``run_rowsel``,
    ``run_tail_wide``); a launch holds at most MAX_ROWS // k images."""
    e, f, h, v, steps = 300, 512, 256, 8192, 40
    n_img = min(n_img, MAX_ROWS // k)
    plan = grid_plan(cell, e, f, h, v, k, n_img, steps, 132)
    rows, nt = n_img * k, -(-v // 256)
    assert plan.rows == rows <= MAX_ROWS and plan.n_tiles == nt
    fact, wide = cell == "factored", k > K_MAX
    want_f = {"v": rows * 4 * f * fact, "hw": rows * 4 * h * fact,
              "s": rows * 4 * f * fact, "hn": 2 * rows * h,
              "cn": 2 * rows * h, "logits": rows * nt * 256,
              "pm": 0 if wide else rows * nt,
              "pse": 0 if wide else rows * nt,
              "pv": rows * (1 if wide else nt) * k,
              "scores": rows, "bscore": n_img}
    want_i = {"bar": 1, "pi": rows * (1 if wide else nt) * k,
              "alive": rows, "word": rows, "prev": rows,
              "seqs": (2 if wide else 1) * rows * (steps + 2),
              "steps": 2 * n_img}
    for regions, want, total in ((plan.floats, want_f, plan.n_floats),
                                 (plan.ints, want_i, plan.n_ints)):
        assert {n: size for n, _, size in regions} == want
        spans = sorted((off, off + size) for _, off, size in regions)
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 <= b0
        assert all(off % 64 == 0 for _, off, _ in regions)  # 256 bytes
        assert total == max(b for _, b in spans)


@pytest.mark.parametrize("k", WIDE_KS)
def test_a_wide_batch_splits_into_launches_of_max_rows_over_k_images(k):
    """MAX_ROWS stays 1,024 rows a launch: at k = 256 a launch takes 4
    images, and every launch but the last is full."""
    per = MAX_ROWS // k
    for batch in (1, per - 1, per, per + 1, 64, 500):
        chunks = launch_chunks(batch, k)
        assert [n for _, n in chunks] == \
            [per] * (batch // per) + ([batch % per] if batch % per else [])
        assert [a for a, _ in chunks] == list(range(0, batch, per))
        assert all(n * k <= MAX_ROWS for _, n in chunks)
    assert launch_chunks(64, 256) == [(i, 4) for i in range(0, 64, 4)]
    assert launch_chunks(64, 20) == [(0, 51), (51, 13)]


@pytest.mark.parametrize("k", WIDE_KS)
def test_the_wide_tail_scratch_fits_the_ring_and_mirrors_the_source(k):
    """Above K_MAX the tail's scratch is the row stage's or the wide
    tail's (the selection's, then a tile a warp and the tiles' max and
    sum-exp; or the k slot state), whatever the length: it fits the ring
    at any vocabulary up to 400,000, as ``tail_floats`` in
    ``csrc/grid_beam.cuh`` computes it; ``merge_floats`` is the source's
    too (the k <= K_MAX merging warps' copies)."""
    body = SOURCE[SOURCE.index("inline long long tail_floats("):]
    body = body[:body.index("\n}\n")]
    assert "const long long rowsel = GB_WARPS * VT + 2LL * n_tiles;" in body
    assert ("const long long tail = state_in_ring(k) ? tail_state_floats(k)"
            " : 0;") in body
    assert "return TOPK_FLOATS + (rowsel > tail ? rowsel : tail);" in body
    assert "return 5LL * k + 4;" in SOURCE   # tail_state_floats
    merge = re.search(r"inline int merge_floats\(int n_tiles, int k\) \{\s*"
                      r"return round4\((.*?)\);", SOURCE, re.S).group(1)
    for v in (516, 8192, 8800, 400000):
        nt = -(-v // 256)
        want = TOPK_FLOATS + max(THREADS // 32 * 256 + 2 * nt, 5 * k + 4)
        for length in (2, 42, 4002):
            assert beam.tail_floats(nt, k, length) == want
        assert want <= beam.NSLOT * SLOT_FLOATS
        assert beam.merge_floats(nt, k) == \
            (eval(merge, {"n_tiles": nt, "k": k}) + 3) & ~3
    grid_plan("factored", 16, 32, 32, 400000, k, 1, 4000, 4)  # no refusal


@pytest.mark.parametrize("k", WIDE_KS)
def test_the_ctypes_plan_carries_a_wide_plan(k):
    """A wide plan through the ctypes mirror: k, the tiles and every
    region's offset as the plan lays them out; the limits it is checked
    against are the source's (KWIDE, TOPK_FLOATS) and the kernel runs the
    wide instantiation above KMAX."""
    n_img = MAX_ROWS // k
    plan = grid_plan("factored", 300, 512, 512, 8192, k, n_img, 40, 132)
    c = beam._c_plan(plan, 1, 2, True)
    assert (c.k, c.n_img, c.n_tiles, c.Vp) == (k, n_img, 32, 8192)
    for name in beam._FLOAT_REGIONS + beam.INT_REGIONS[:7]:
        assert getattr(c, "o_" + name) == plan.region(name)[0]
    assert (c.o_cand, c.o_lists, c.o_tstate) == (0, 0, 0)  # SEL_SCAN's
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", SOURCE))
    assert int(consts["KWIDE"]) == K_WIDE >= k > int(consts["KMAX"]) == K_MAX
    assert int(consts["TOPK_FLOATS"]) == TOPK_FLOATS
    assert plan.selection == SEL_WIDE
    assert "sel == SEL_SCAN ? scan : sel == SEL_WIDE ? wide : narrow" in SOURCE
    assert "if (k > KWIDE) return SEL_SCAN;" in SOURCE
    assert "p.k < 1 || p.k > MAX_K" in SOURCE


def test_a_batch_splits_into_launches_of_at_most_max_rows():
    for batch, k in ((1, 5), (8, 5), (64, 5), (64, 8), (300, 5), (2049, 1),
                     (1024, 1), (129, 8)):
        chunks = launch_chunks(batch, k)
        assert chunks[0][0] == 0
        assert sum(n for _, n in chunks) == batch
        for (a, n), (b, _) in zip(chunks, chunks[1:]):
            assert a + n == b
        assert all(1 <= n and n * k <= MAX_ROWS for _, n in chunks)
        assert len(chunks) == -(-batch * k // (MAX_ROWS // k * k))
    assert launch_chunks(64, 5) == [(0, 64)]
    assert launch_chunks(300, 5) == [(0, 204), (204, 96)]


@pytest.mark.parametrize("kwargs", [
    # the widths the card refused before it took a padded layout
    dict(v=130), dict(f=42), dict(h=30),
    # V of each residue mod 4 at the flagship widths, ragged F and H
    dict(e=300, f=512, h=512, v=8189), dict(e=300, f=512, h=512, v=8190),
    dict(e=300, f=512, h=512, v=8191), dict(e=300, f=510, h=511, v=8191),
    dict(f=1, h=3, v=5), dict(cell="lstm", f=511, h=511, v=8189, k=20),
])
def test_the_plan_takes_widths_that_are_not_multiples_of_4(kwargs):
    """F, H and V of any residue mod 4 plan as their padded widths (each
    rounded up to 4: the layout the wrapper hands the kernel,
    ``ops/widths.py``), the same plan field for field."""
    args = dict(cell="factored", e=16, f=32, h=32, v=512, k=5, n_img=2,
                max_seq=9, grid=4)
    args.update(kwargs)
    plan = grid_plan(**args)
    quads = {n: -(-args[n] // 4) * 4 for n in ("f", "h", "v")}
    assert (plan.f, plan.h, plan.v) == (quads["f"], quads["h"], quads["v"])
    assert plan == grid_plan(**dict(args, **quads))
    assert plan.n_tiles == -(-args["v"] // 256)


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=0), "k=0"), (dict(k=513), r"k=513 outside \[1, 512\]"),
    (dict(v=4, k=5), "k=5"),
    (dict(n_img=205, k=5), "1025 rows"),
    (dict(grid=0), "grid=0"), (dict(n_img=0), "n_img=0"),
    (dict(cell="gru"), "unknown cell"), (dict(v=4000000), "tail's"),
    (dict(v=50000, k=MAX_K + 1, n_img=1), "by an int"),
])
def test_the_plan_raises_on_what_the_kernel_does_not_take(kwargs, match):
    args = dict(cell="factored", e=16, f=32, h=32, v=512, k=5, n_img=2,
                max_seq=9, grid=4)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        grid_plan(**args)


@pytest.mark.parametrize("k,v,n_img", [
    (257, 8192, 1), (512, 8192, 2), (1024, 8192, 1), (2048, 8192, 1),
    (300, 8192, 3), (1000, 1000, 1), (8192, 8192, 1)])
@pytest.mark.parametrize("cell", ["factored", "lstm"])
def test_the_plan_takes_beams_past_one_block(cell, k, v, n_img):
    """Above K_WIDE the search runs ``SEL_SCAN``: each block's survivors
    (k pairs) in ``cand``, the tail's slot state in ``tstate`` once it
    outgrows the ring, the row lists in ``lists`` once one image holds
    more than MAX_ROWS rows; k = V too.  The ctypes plan carries each
    region's offset."""
    grid, steps = 132, 8
    plan = grid_plan(cell, 300, 512, 512, v, k, n_img, steps, grid)
    rows = n_img * k
    assert plan.selection == SEL_SCAN and plan.rows == rows
    sizes = {n: size for n, _, size in plan.ints}
    state = 5 * k + 4
    assert sizes["cand"] == 2 * grid * k
    assert sizes["tstate"] == (0 if TOPK_FLOATS + state <= 4 * SLOT_FLOATS
                               else grid * state)
    assert sizes["lists"] == (8 * grid * rows if rows > MAX_ROWS else 0)
    assert sizes["pi"] == rows * k and sizes["seqs"] == 2 * rows * (steps + 2)
    assert beam.tail_floats(plan.n_tiles, k, steps + 2) <= 4 * SLOT_FLOATS
    c = beam._c_plan(plan, 1, 2, False)
    for name in beam._FLOAT_REGIONS + beam.INT_REGIONS:
        assert getattr(c, "o_" + name) == plan.region(name)[0]
    spans = sorted((off, off + size) for _, off, size in plan.ints)
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert all(off % 64 == 0 for _, off, _ in plan.ints)


@pytest.mark.parametrize("k,n_img,sel", [
    (5, 1, SEL_WIDE), (5, 8, SEL_WIDE), (8, 64, SEL_WIDE),
    (1, 64, SEL_NARROW), (20, 8, SEL_WIDE)])
def test_the_narrow_tails_vocabulary_bound_is_gone(k, n_img, sel):
    """At V = 100,000 the narrow tail's partials (K_MAX warps' copies of
    n_tiles partials) do not fit the ring: k <= 8 takes the wide row
    stage and tail, whose scratch does not grow with V but for the
    tiles' max and sum-exp; so do the shapes that refused before (V =
    400,000; 4,000 steps)."""
    plan = grid_plan("factored", 300, 512, 512, 100000, k, n_img, 40, 132)
    assert plan.selection == sel
    assert (sel == SEL_WIDE) == (
        beam.narrow_tail_floats(plan.n_tiles, k, 42) > 4 * SLOT_FLOATS
        or k > K_MAX)
    sizes = {n: size for n, _, size in plan.floats}
    if sel == SEL_WIDE:   # (k = 1: one candidate a tile still fits)
        assert sizes["pm"] == 0 and sizes["pv"] == n_img * k * k
    for v, steps in ((400000, 9), (512, 4000)):
        assert grid_plan("factored", 16, 32, 32, v, 5, 2, steps,
                         4).selection == SEL_WIDE
    assert grid_plan("factored", 300, 512, 512, 80384, 5, 1, 40,
                     132).selection == SEL_NARROW


@pytest.mark.parametrize("k", [1025, 2048, 46340, 100000])
def test_launch_chunks_never_give_an_empty_launch(k):
    """Above MAX_ROWS a launch takes one image."""
    for batch in (1, 3, 64):
        assert launch_chunks(batch, k) == [(i, 1) for i in range(batch)]


def _narrow_cases():
    """The shapes whose plans the parent commit made (k <= 256; the narrow
    tail where it fit)."""
    for cell in ("factored", "lstm"):
        for k in (1, 2, 5, 8, 9, 20, 64, 256):
            for v in (516, 8192, 8800, 40000):
                for n_img in sorted({1, 4, MAX_ROWS // k}):
                    for max_seq in (0, 20, 40):
                        for grid in (1, 8, 132):
                            yield (cell, 300, 512, 512, v, k, n_img,
                                   max_seq, grid)


# sha256 of the parent commit's plans of _narrow_cases(): each plan's repr,
# its ctypes struct's fields (arrays as lists) and launch_chunks(64, k)
NARROW_PLANS = \
    "062b6e1faf48b2e9b813a2e51776128264e9ef009b74314308228b1a5ae039ca"


def test_every_plan_the_narrower_paths_made_is_unchanged():
    """Every shape that planned before (k <= 256; the narrow tail where it
    fit) keeps its plan field for field: the digest of the plans, their
    ctypes structs (SEL_SCAN's offsets left out: 0 there; the tile fields,
    which the tile plans' own digest holds,
    tests/test_torch_search_tiles.py) and the launch split is the parent
    commit's."""
    import hashlib

    h = hashlib.sha256()
    for args in _narrow_cases():
        plan = grid_plan(*args)
        c = beam._c_plan(plan, 1, 2, True)
        assert (c.o_cand, c.o_lists, c.o_tstate) == (0, 0, 0)
        fields = [getattr(c, f) for f, _ in c._fields_
                  if f not in ("o_cand", "o_lists", "o_tstate")
                  + beam.TILE_ARRAYS]
        h.update(repr(plan).encode())
        h.update(repr([list(x) if hasattr(x, "__len__") else x
                       for x in fields]).encode())
        h.update(repr(launch_chunks(64, args[5])).encode())
    assert h.hexdigest() == NARROW_PLANS


def _params(vocab=128, e=16, h=32, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    return bridge.to_torch({
        "B": w(vocab, e), "V_w": w(e, 4 * h), "V_b": w(4, h),
        "S_w": w(4, 4, h, h), "S_b": w(4, 4, h), "U_w": w(4, h, h),
        "U_b": w(4, h), "W_w": w(h, 4 * h), "W_b": w(4, h),
        "C_w": w(h, vocab), "C_b": w(vocab)})


def test_the_wrapper_raises_before_the_cpu_route():
    params = _params()
    # every route decodes any k up to V (the card's:
    # tests/test_torch_cuda.py)
    got, steps = mega_beam_decode_steps(params, None, 0, 2, k=9,
                                        max_seq_length=3)
    assert steps is None and got.tokens.shape == (2, 5)
    with pytest.raises(ValueError, match="k=0"):
        mega_beam_decode_steps(params, None, 0, 2, k=0)
    with pytest.raises(ValueError, match="style 4"):
        mega_beam_decode_steps(params, None, 4, 2, k=2)
    with pytest.raises(ValueError, match="shape"):
        mega_beam_decode_steps(params, torch.zeros((2, 3, 16)), 0, 2, k=2)
    with pytest.raises(ValueError, match="unknown cell"):
        mega_beam_decode_steps(params, None, 0, 2, k=2, cell="gru")
    got, steps = mega_beam_decode_steps(params, None, 1, 3, k=2,
                                        max_seq_length=4)
    assert steps is None and got.tokens.shape == (3, 6)


def _c_struct_fields(name: str) -> list:
    body = re.search(r"struct %s \{(.*?)\n\};" % name, SOURCE, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.replace("long long", "").strip()
        fields += [d.strip() for d in decl.split(",") if d.strip()]
    return fields


def test_the_ctypes_plan_mirrors_the_kernels_struct():
    c_fields = _c_struct_fields("GridPlan")
    py_fields = []
    for name, ctype in beam._CPlan._fields_:
        n = getattr(ctype, "_length_", None)
        py_fields.append(f"{name}[MAX_STAGES]" if n else name)
    assert py_fields == c_fields
    assert all(t is __import__("ctypes").c_longlong or
               getattr(t, "_type_", None) is __import__("ctypes").c_longlong
               for _, t in beam._CPlan._fields_)


def test_the_wrappers_geometry_is_the_kernels():
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", SOURCE))
    assert int(consts["GB_THREADS"]) == THREADS
    assert int(consts["KC"]) == KC
    assert consts["KCP"] == "KC + 4" and KCP == KC + 4
    assert int(consts["NSLOT"]) == beam.NSLOT
    assert int(consts["SLOT_FLOATS"]) == SLOT_FLOATS
    assert int(consts["MAX_ROWS"]) == MAX_ROWS
    assert int(consts["MAX_BR"]) == MAX_BR
    assert int(consts["MAX_UNIT_ROWS"]) == beam.MAX_UNIT_ROWS
    assert int(consts["MAX_STAGES"]) == beam.MAX_STAGES
