"""The host side of K2's whole-card search (``icee_tpu_torch/ops/beam.py``):
the launch plan that ``csrc/beam.cu`` reads.  Every stage's column slabs
must cover each output column of each of its products once and in order
(a ragged vocabulary, F != H, grids of 1 to 132 blocks); the slabs and row
blocks must fit the kernel's chunk slots; the scratch regions must be
disjoint, aligned and of the sizes the kernel indexes, at 1, 8 and 64
images and k = 1, 5, 8; a batch must split into launches of at most
``MAX_ROWS`` rows; and the plan and the wrapper must raise on what the
kernel does not take.  The ctypes mirror of the kernel's ``GridPlan`` and
its geometry constants are held against the CUDA sources' text
(``csrc/beam.cu`` and the ``csrc/grid_beam.cuh`` it shares with K7).  The
kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch import bridge
from icee_tpu_torch.ops import beam
from icee_tpu_torch.ops.beam import (KC, KCP, MAX_BR, MAX_ROWS, SLOT_FLOATS,
                                     THREADS, grid_plan, launch_chunks,
                                     mega_beam_decode_steps, slab_columns)

CSRC = Path(beam.__file__).resolve().parents[1] / "csrc"
# the kernel and the machinery it shares with K7
SOURCE = "".join((CSRC / n).read_text() for n in ("beam.cu",
                                                  "grid_beam.cuh"))
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
    table = plan.slab_table()
    assert table.shape == (sum(len(st.slabs) for st in plan.stages), 4)
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


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("n_img", [1, 8, 64])
@pytest.mark.parametrize("cell", ["factored", "lstm"])
def test_scratch_regions_are_disjoint_aligned_and_sized(cell, n_img, k):
    e, f, h, v, steps = 300, 512, 256, 8192, 40
    plan = grid_plan(cell, e, f, h, v, k, n_img, steps, 132)
    rows, nt = n_img * k, -(-v // 256)
    assert plan.rows == rows <= MAX_ROWS and plan.n_tiles == nt
    fact = cell == "factored"
    want_f = {"v": rows * 4 * f * fact, "hw": rows * 4 * h * fact,
              "s": rows * 4 * f * fact, "hn": 2 * rows * h,
              "cn": 2 * rows * h, "logits": rows * nt * 256,
              "pm": rows * nt, "pse": rows * nt, "pv": rows * nt * k,
              "scores": rows, "bscore": n_img}
    want_i = {"bar": 1, "pi": rows * nt * k, "alive": rows, "word": rows,
              "prev": rows, "seqs": rows * (steps + 2),
              "steps": 2 * n_img}
    for regions, want, total in ((plan.floats, want_f, plan.n_floats),
                                 (plan.ints, want_i, plan.n_ints)):
        assert {n: size for n, _, size in regions} == want
        spans = sorted((off, off + size) for _, off, size in regions)
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 <= b0
        assert all(off % 64 == 0 for _, off, _ in regions)  # 256 bytes
        assert total == max(b for _, b in spans)


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


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=0), "k=0"), (dict(k=9), "k=9"), (dict(v=4, k=5), "k=5"),
    (dict(v=130), "multiples of 4"), (dict(f=42), "multiples of 4"),
    (dict(h=30), "multiples of 4"), (dict(n_img=205, k=5), "1025 rows"),
    (dict(grid=0), "grid=0"), (dict(n_img=0), "n_img=0"),
    (dict(cell="gru"), "unknown cell"), (dict(v=400000), "tail's"),
    (dict(max_seq=4000), "tail's"),
])
def test_the_plan_raises_on_what_the_kernel_does_not_take(kwargs, match):
    args = dict(cell="factored", e=16, f=32, h=32, v=512, k=5, n_img=2,
                max_seq=9, grid=4)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        grid_plan(**args)


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
    # above the kernel's K_MAX = 8 the plain route decodes (the card
    # refuses: tests/test_torch_cuda.py)
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
