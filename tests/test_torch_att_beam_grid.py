"""The host side of K7's whole-card search (``icee_tpu_torch/ops/att_beam.py``):
the launch plan that ``csrc/att_beam.cu`` reads.  Every product stage's
column slabs must cover each output column of each of its products once
and in order, and the scores stage's units each image's P positions once
and in order (grids of 1 to 132 blocks, 1 to 64 images); the stages must
fit the kernel's chunk slots and threads; the scratch regions must be
disjoint, aligned and of the sizes the kernel indexes, at 1, 8 and 64
images and k = 1, 5, 8, both kinds; the plan and the wrapper must raise on
what the kernel does not take.  The ctypes mirror of the kernel's
``AttGridPlan``, its geometry constants and its stage list are held
against the CUDA sources' text.  No JAX: the search itself is held against
JAX in ``tests/test_torch_att_beam.py`` and runs on the card in
``tests/test_torch_cuda.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch import bridge
from icee_tpu_torch.ops import att_beam, beam
from icee_tpu_torch.ops.att_beam import (CTX_STAGE, MAX_P, att_grid_plan,
                                         att_stage_jobs,
                                         mega_att_beam_decode_steps)
from icee_tpu_torch.ops.beam import (KC, KCP, MAX_BR, MAX_ROWS, NSLOT,
                                     SLOT_FLOATS, THREADS, slab_columns)

CSRC = Path(att_beam.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "att_beam.cu").read_text()
SHARED = (CSRC / "grid_beam.cuh").read_text()
SHAPES = [  # (kind, E, F, H, V, A, P, FS)
    ("factored", 300, 512, 512, 8192, 512, 196, 2048),  # flagship
    ("factored", 30, 40, 48, 516, 20, 9, 64),   # ragged V, F != H, E % 4
    ("lstm", 300, 512, 512, 8192, 512, 196, 2048),
    ("lstm", 30, 48, 48, 516, 20, 9, 64),
]
STAGE_NAMES = {
    "factored": [["att2", "gpre", "hw", "xpart"], ["ctx"], ["v"], ["s"],
                 ["z"], ["logits"], ["h0", "c0"]],
    "lstm": [["att2", "gpre", "hw", "xpart"], ["ctx"], ["gates"],
             ["logits"], ["h0", "c0"]],
}


def _plan(shape, k=5, n_img=8, max_seq=40, grid=132):
    kind, e, f, h, v, a, p, fs = shape
    return att_grid_plan(kind, e, f, h, v, a, p, fs, k, n_img, max_seq, grid)


@pytest.mark.parametrize("grid", [1, 3, 8, 132])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_units_cover_each_column_and_position_once_in_order(shape, grid):
    kind, e, f, h, v, a, p, fs = shape
    want = {"att2": a, "gpre": fs, "hw": 4 * h, "xpart": 4 * f, "ctx": fs,
            "v": 4 * f, "s": 4 * f, "z": 4 * h, "gates": 4 * h,
            "logits": v, "h0": h, "c0": h}
    for n_img in (1, 3, 64):
        plan = _plan(shape, n_img=n_img, grid=grid)
        assert [[j.name for j in st.jobs] for st in plan.stages] == \
            STAGE_NAMES[kind]
        for st in plan.stages:
            for ji, job in enumerate(st.jobs):
                cols = slab_columns(st, ji)
                if job.gates:   # gate by gate within a slab, slabs in order
                    assert sorted(cols) == list(range(want[job.name]))
                    per_gate = [[c - g * job.segw for c in cols
                                 if g * job.segw <= c < (g + 1) * job.segw]
                                for g in range(4)]
                    assert all(q == list(range(job.segw)) for q in per_gate)
                else:
                    assert cols == list(range(want[job.name]))
            for ji, seg, c0, width in st.slabs:
                job = st.jobs[ji]
                assert c0 % 4 == 0 and width % 4 == 0 and width > 0
                assert c0 + width <= job.segw and 0 <= seg < job.nseg
                assert width <= (st.cw // 4 if job.gates else st.cw)
        # the scores stage: unit u of the live images is image u // upi,
        # positions [part * pu, min(P, (part + 1) * pu)), part = u % upi
        positions = {}
        for u in range(n_img * plan.upi):
            img, part = divmod(u, plan.upi)
            got = list(range(part * plan.pu, min(p, (part + 1) * plan.pu)))
            assert got, "an empty scores unit"
            positions.setdefault(img, []).extend(got)
        assert positions == {i: list(range(p)) for i in range(n_img)}
        table = plan.slab_table()
        assert table.shape == (sum(len(st.slabs) for st in plan.stages), 4)
        assert table.dtype == np.int32


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_stages_fit_the_kernels_slots_and_threads(shape):
    kind, e, f, h, v, a, p, fs = shape
    for grid in (1, 2, 132):
        for n_img in (1, 8, 128):
            plan = _plan(shape, k=8, n_img=n_img, grid=grid)
            for st in plan.stages:
                lanes = THREADS // (st.cw // 4)
                sets = max(j.sets for j in st.jobs)
                assert st.cw in (16, 32, 64)
                assert 1 <= st.br <= min(MAX_BR, 2 * lanes)
                assert KC * st.cw + sets * st.br * KCP <= SLOT_FLOATS
                assert sets * st.br <= beam.MAX_UNIT_ROWS
                assert st.br * st.cw <= 64 * 64   # a gate unit's z exchange
                assert 8 <= lanes   # an image's k rows, a thread each
            # att2 rows of an image in the ring; the softmax rows in theirs
            assert 8 * a <= NSLOT * SLOT_FLOATS and p <= MAX_P
            assert plan.pu >= 1 and plan.pu * plan.upi >= p
    # one image on 132 SMs: every stage is one round of units
    for kind in ("factored", "lstm"):
        plan = _plan((kind, 300, 512, 512, 8192, 512, 196, 2048), n_img=1)
        assert all(len(st.slabs) <= 132 for st in plan.stages)
        assert plan.upi <= 132


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("n_img", [1, 8, 64])
@pytest.mark.parametrize("kind", ["factored", "lstm"])
def test_scratch_regions_are_disjoint_aligned_and_sized(kind, n_img, k):
    e, f, h, v, a, p, fs, steps = 300, 512, 512, 8192, 512, 196, 2048, 40
    plan = att_grid_plan(kind, e, f, h, v, a, p, fs, k, n_img, steps, 132)
    rows, nt = n_img * k, -(-v // 256)
    assert plan.rows == rows <= MAX_ROWS and plan.n_tiles == nt
    fact = kind == "factored"
    want_f = {"att2": rows * a, "gpre": rows * fs, "hw": rows * 4 * h,
              "xpart": rows * 4 * f, "esc": rows * p, "ctx": rows * fs,
              "v": rows * 4 * f * fact, "s": rows * 4 * f * fact,
              "hn": 2 * rows * h, "cn": 2 * rows * h,
              "logits": rows * nt * 256, "pm": rows * nt, "pse": rows * nt,
              "pv": rows * nt * k, "scores": rows, "bscore": n_img,
              "mean": n_img * fs}
    want_i = {"bar": 1, "pi": rows * nt * k, "alive": rows, "word": rows,
              "prev": rows, "seqs": rows * (steps + 2), "steps": 2 * n_img}
    for regions, want, total in ((plan.floats, want_f, plan.n_floats),
                                 (plan.ints, want_i, plan.n_ints)):
        assert {n: size for n, _, size in regions} == want
        spans = sorted((off, off + size) for _, off, size in regions)
        for (a0, a1), (b0, _) in zip(spans, spans[1:]):
            assert a1 <= b0
        assert all(off % 64 == 0 for _, off, _ in regions)  # 256 bytes
        assert total == max(b for _, b in spans)


@pytest.mark.parametrize("kwargs,match", [
    (dict(k=0), "k=0"), (dict(k=9), "k=9"), (dict(v=4, k=5), "k=5"),
    (dict(v=130), "multiples of 4"), (dict(f=42), "multiples of 4"),
    (dict(a=18), "multiples of 4"), (dict(fs=66), "multiples of 4"),
    (dict(p=0), "P=0"), (dict(p=MAX_P + 1), f"P={MAX_P + 1}"),
    (dict(a=4096), "ring"), (dict(n_img=205, k=5), "1025 rows"),
    (dict(grid=0), "grid=0"), (dict(n_img=0), "n_img=0"),
    (dict(kind="gru"), "unknown kind"), (dict(kind="lstm", f=48), "f=48"),
    (dict(v=400000), "tail's"), (dict(max_seq=4000), "tail's"),
])
def test_the_plan_raises_on_what_the_kernel_does_not_take(kwargs, match):
    args = dict(kind="factored", e=16, f=32, h=32, v=512, a=20, p=9, fs=64,
                k=5, n_img=2, max_seq=9, grid=4)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        att_grid_plan(**args)


def _params(vocab=64, e=8, h=16, a=8, fs=12, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    return bridge.to_torch({
        "B": w(vocab, e), "V_w": w(e + fs, 4 * h), "V_b": w(4, h),
        "S_w": w(4, 4, h, h), "S_b": w(4, 4, h), "U_w": w(4, h, h),
        "U_b": w(4, h), "W_w": w(h, 4 * h), "W_b": w(4, h),
        "C_w": w(h, vocab), "C_b": w(vocab),
        "attention": {"enc_w": w(4, fs, a), "enc_b": w(4, a),
                      "dec_w": w(4, h, a), "dec_b": w(4, a),
                      "full_w": w(4, a, 1), "full_b": w(4, 1)},
        "init_h_w": w(fs, h), "init_h_b": w(h), "init_c_w": w(fs, h),
        "init_c_b": w(h), "f_beta_w": w(h, fs), "f_beta_b": w(fs)})


def test_the_wrapper_raises_before_the_cpu_route():
    params = _params()
    feats = torch.zeros((2, 5, 12))
    with pytest.raises(ValueError, match="k=0"):
        mega_att_beam_decode_steps(params, feats, 0, 2, k=0)
    with pytest.raises(ValueError, match="k=65"):
        mega_att_beam_decode_steps(params, feats, 0, 2, k=65)
    with pytest.raises(ValueError, match="style 4"):
        mega_att_beam_decode_steps(params, feats, 4, 2, k=2)
    with pytest.raises(ValueError, match="shape"):
        mega_att_beam_decode_steps(params, feats[:, :, :8], 0, 2, k=2)
    with pytest.raises(ValueError, match="unknown kind"):
        mega_att_beam_decode_steps(params, feats, 0, 2, k=2, kind="gru")
    # the plain route takes any k up to V (the card refuses k > 8)
    got, steps = mega_att_beam_decode_steps(params, feats, 1, 2, k=9,
                                            max_seq_length=3)
    assert steps is None and got.tokens.shape == (2, 5)


def _c_struct_fields(name: str) -> list:
    body = re.search(r"struct %s \{(.*?)\n\};" % name, SOURCE, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.replace("long long", "").strip()
        fields += [d.strip() for d in decl.split(",") if d.strip()]
    return fields


def test_the_ctypes_plan_mirrors_the_kernels_struct():
    py_fields = []
    for name, ctype in att_beam._CAttPlan._fields_:
        n = getattr(ctype, "_length_", None)
        py_fields.append(f"{name}[MAX_STAGES]" if n else name)
        assert (ctype if not n else ctype._type_) is ctypes.c_longlong
    assert py_fields == _c_struct_fields("AttGridPlan")


def test_the_wrappers_geometry_is_the_kernels():
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", SHARED))
    assert int(consts["MAX_P"]) == MAX_P
    assert int(consts["GB_THREADS"]) == THREADS
    assert int(consts["MAX_STAGES"]) == beam.MAX_STAGES
    assert int(consts["MAX_ROWS"]) == MAX_ROWS
    assert int(consts["MAX_JOBS"]) >= max(
        sum(len(js) for js in att_stage_jobs(kind, 30, 48, 48, 516, 20, 64))
        for kind in ("factored", "lstm"))


@pytest.mark.parametrize("kind,fn", [("factored", "icee_mega_att_beam_decode"),
                                     ("lstm", "icee_mega_att_beam_decode_lstm")])
def test_the_kernels_stage_list_is_the_plans(kind, fn):
    """Each entry point's stage_of calls (first job, jobs, per image) in
    order give the plan's stages, the context the one per-image stage."""
    body = SOURCE[SOURCE.index(f'extern "C" int {fn}('):]
    body = body[:body.index("\n}\n")]
    calls = re.findall(r"stage_of\(a, (\d+), \w+, (\d+)(?:, (\d))?\)", body)
    jobs = att_stage_jobs(kind, 30, 48, 48, 516, 20, 64)
    assert [int(s) for s, _, _ in calls] == list(range(len(jobs)))
    assert [int(n) for _, n, _ in calls] == [len(js) for js in jobs]
    assert [i for i, (_, _, img) in enumerate(calls) if img == "1"] == \
        [CTX_STAGE]
    assert f"p.n_stages != {len(jobs)}" in body
    assert f"a.n_jobs = {sum(len(js) for js in jobs)};" in body
