"""The host side of K7's whole-card search (``icee_tpu_torch/ops/att_beam.py``):
the launch plan that ``csrc/att_beam.cu`` reads.  Every product stage's
column slabs must cover each output column of each of its products once
and in order, and the scores stage's units each image's P positions once
and in order (grids of 1 to 132 blocks, 1 to 64 images); the stages must
fit the kernel's chunk slots and threads; the scratch regions must be
disjoint, aligned and of the sizes the kernel indexes, at 1, 8 and 64
images and k = 1, 5, 8, both kinds; the plan and the wrapper must raise on
what the kernel does not take.  The h0/c0 launch (the search's mean and
init stage alone: ``run_mean``'s tasks, then ``att_init_plan``'s stage)
must cover each (image, column quad) of the mean and each h0/c0 column of
each image once, at 1, 2 and 64 images.  The ctypes mirrors of the
kernel's ``AttGridPlan`` and ``AttInitPlan``, its geometry constants, its
stage lists and its entry points' argument counts are held against the
CUDA sources' text.  No JAX: the search itself is held against JAX in
``tests/test_torch_att_beam.py`` and runs on the card in
``tests/test_torch_cuda.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from icee_tpu_torch import bridge
from icee_tpu_torch.ops import att_beam, att_decode_step, beam
from icee_tpu_torch.ops.att_beam import (CTX_STAGE, MAX_P, att_grid_plan,
                                         att_init_plan, att_stage_jobs,
                                         init_stage_jobs,
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


def _row_blocks(n: int, br: int) -> list:
    """The rows of each unit of a stage that is not per image, as
    ``csrc/grid_beam.cuh``'s unit_of splits n live rows into blocks."""
    n_rb = -(-n // br)
    base, rem = divmod(n, n_rb)
    out = []
    for rb in range(n_rb):
        i0 = rb * base + min(rb, rem)
        out.append(list(range(i0, i0 + base + (1 if rb < rem else 0))))
    return out


def _mean_tasks(n_img: int, fs: int, grid: int) -> dict:
    """The (image, column quad) each thread of ``run_mean`` sums, as its
    grid-stride loop walks the tasks: -> {(image, quad): times}."""
    nq, out = fs // 4, {}
    for b in range(grid):
        for tid in range(THREADS):
            for task in range(b * THREADS + tid, n_img * nq, grid * THREADS):
                key = divmod(task, nq)
                out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("grid", [3, 132])
@pytest.mark.parametrize("n_img", [1, 2, 64])
@pytest.mark.parametrize("h,p,fs", [(512, 196, 2048), (48, 9, 64)])
def test_init_plan_covers_each_mean_quad_and_output_column_once(
        h, p, fs, n_img, grid):
    """The h0/c0 launch as the kernel walks it: ``run_mean``'s tasks give
    each (image, column quad) exactly once, a thread's chain over all P;
    the init stage's units (slab, row block) give each (image, h0 or c0
    column) exactly once, a chain over all FS.  The stage fits the
    kernel's slots and threads."""
    assert _mean_tasks(n_img, fs, grid) == {
        (i, q): 1 for i in range(n_img) for q in range(fs // 4)}
    mean = SOURCE[SOURCE.index("__device__ void run_mean("):]
    mean = mean[:mean.index("\n}\n")]
    assert ("task = blockIdx.x * GB_THREADS + threadIdx.x; task < a.n_img * "
            "nq;\n       task += gridDim.x * GB_THREADS") in mean
    plan = att_init_plan(h, p, fs, n_img, grid)
    (init,) = plan.stages
    assert [j.name for j in init.jobs] == ["h0", "c0"]
    cols = {}
    for ji, seg, c0, width in init.slabs:
        assert seg == 0 and c0 % 4 == 0 and width % 4 == 0
        for rows in _row_blocks(n_img, init.br):
            assert len(rows) <= init.br
            for i in rows:
                for c in range(c0, c0 + width):
                    key = (init.jobs[ji].name, i, c)
                    cols[key] = cols.get(key, 0) + 1
    assert cols == {(n, i, c): 1 for n in ("h0", "c0")
                    for i in range(n_img) for c in range(h)}
    assert init.cw in (16, 32, 64)
    assert 1 <= init.br <= min(MAX_BR, 2 * THREADS // (init.cw // 4))
    assert KC * init.cw + init.br * KCP <= SLOT_FLOATS
    # the card's 132 SMs: one round of units at one image
    if grid == 132 and n_img == 1 and fs == 2048:
        assert len(init.slabs) <= 132
    assert plan.region("mean") == (0, n_img * fs)
    assert plan.n_floats == n_img * fs
    assert plan.slab_table().shape == (len(init.slabs), 4)


def test_the_search_plans_its_init_stage_as_the_init_launch_does():
    """The search's last stage is the h0/c0 launch's, planned alike (over
    the images, not the rows)."""
    for n_img in (1, 2, 8, 64):
        init = att_init_plan(512, 196, 2048, n_img, 132)
        for kind in ("factored", "lstm"):
            plan = att_grid_plan(kind, 300, 512, 512, 8192, 512, 196, 2048,
                                 5, n_img, 40, 132)
            assert plan.stages[-1:] == init.stages
    assert init_stage_jobs(512) == tuple(
        att_stage_jobs("lstm", 300, 512, 512, 8192, 512, 2048)[-1])


@pytest.mark.parametrize("kwargs,match", [
    (dict(h=42), "multiples of 4"), (dict(fs=66), "multiples of 4"),
    (dict(p=0), "P=0"), (dict(n_img=0), "n_img=0"), (dict(grid=0), "grid=0"),
    (dict(n_img=MAX_ROWS + 1), f"{MAX_ROWS + 1} images"),
])
def test_the_init_plan_raises_on_what_the_kernel_does_not_take(kwargs,
                                                                match):
    args = dict(h=48, p=9, fs=64, n_img=2, grid=4)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        att_init_plan(**args)


def test_the_ctypes_init_plan_mirrors_the_kernels_struct():
    body = re.search(r"struct AttInitPlan \{(.*?)\n\};", SOURCE,
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.replace("long long", "").strip()
        fields += [d.strip() for d in decl.split(",") if d.strip()]
    py_fields = []
    for name, ctype in att_beam._CInitPlan._fields_:
        n = getattr(ctype, "_length_", None)
        py_fields.append(f"{name}[MAX_STAGES]" if n else name)
        assert (ctype if not n else ctype._type_) is ctypes.c_longlong
    assert py_fields == fields


def test_the_init_entry_points_stages_are_the_plans():
    """icee_att_init_state: the search's run_mean (part 0), then its h0
    and c0 jobs, built by the helper the search uses, as the plan's one
    stage (part 1)."""
    body = SOURCE[SOURCE.index('extern "C" int icee_att_init_state('):]
    body = body[:body.index("\n}\n")]
    assert "init_jobs(a.jobs, fs + p.o_mean," in body
    assert "stage_of(a, 0, 0, 2);" in body and "p.n_stages != 1" in body
    assert "(a, 0);" in body and "(a, 1);" in body
    assert len(init_stage_jobs(48)) == 2
    kernel = SOURCE[SOURCE.index("grid_att_init_kernel(const"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert "run_mean(a);" in kernel and "run_stage(a, stages[0], sm, c);" \
        in kernel
    shared = SOURCE[SOURCE.index("static void attention_jobs("):]
    shared = shared[:shared.index("\n}\n")]
    assert "init_jobs(a.jobs + init, fs + p.o_mean," in shared
    # the one-block-an-image kernel and its device function are gone
    assert "icee_att_init_state" not in (CSRC / "att_decode_step.cu"
                                         ).read_text()
    assert "init_state(" not in (CSRC / "att_common.cuh").read_text()


@pytest.mark.parametrize("module,source,fn", [
    (att_beam, "att_beam.cu", "icee_mega_att_beam_decode"),
    (att_beam, "att_beam.cu", "icee_mega_att_beam_decode_lstm"),
    (att_beam, "att_beam.cu", "icee_att_init_state"),
    (att_beam, "att_beam.cu", "icee_mega_att_beam_max_grid"),
    (att_decode_step, "att_decode_step.cu", "icee_att_decode_step_topk"),
    (att_decode_step, "att_decode_step.cu",
     "icee_att_decode_step_topk_lstm"),
    (att_decode_step, "att_decode_step.cu",
     "icee_att_decode_step_topk_split"),
    (att_decode_step, "att_decode_step.cu",
     "icee_att_decode_step_topk_lstm_split"),
])
def test_the_ctypes_signatures_match_the_entry_points(module, source, fn,
                                                      monkeypatch):
    from icee_tpu_torch.ops import cuda_lib

    declared = {}

    def fake_library(name, signatures):
        declared.update(signatures)
        raise RuntimeError("stop")

    monkeypatch.setattr(cuda_lib, "library", fake_library)
    with pytest.raises(RuntimeError, match="stop"):
        module._library()
    text = (CSRC / source).read_text()
    sig = re.search(r'extern "C" \w+ %s\((.*?)\)\s*\{' % fn, text,
                    re.S).group(1)
    assert len(declared[fn][0]) == len([p for p in sig.split(",")
                                        if p.strip()])
