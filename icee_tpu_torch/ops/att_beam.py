"""K7: the whole attention beam search in one launch, for StyleNet+Att
(``kind="factored"``) and NIC+Att (``kind="lstm"``).

Port of ``icee_tpu/ops/pallas_att_decode.py::mega_att_beam_decode``, both
of its calls (the resident and the P-streamed one, which compute the same
function).  The CUDA kernel is ``csrc/att_beam.cu``: ONE cooperative launch
of one block per SM, persistent over every step, spreads each step of the
search over the whole card (K2's design, ``csrc/grid_beam.cuh``).  A step
runs as stages separated by a grid barrier: the products of h and of the
embedding, the attention scores (units of an image's positions), the
context (units of an image's feature columns, the softmax in every block),
the rest of the cell, the vocabulary head, the per-tile top-k partials and
each image's beam tail; h0/c0 from the mean feature before step 1.  Only
the beams still alive run.  :func:`att_grid_plan` is the launch plan the
kernel reads.  :func:`init_state` runs the search's mean and h0/c0 stage
alone for the fused-step path (``att_decode_step.att_init_state``),
planned by :func:`att_init_plan`.  The TPU scheduling knobs
(``n_img_block``, ``n_streams``, ``topk_fold``, ``p_stream``, ``p_tile``,
``_profile``) have no counterpart.  :func:`mega_att_beam_decode_plain` is
the same search in plain PyTorch (``beam_search_batched`` over the
decoder's full-vocabulary step): the CPU tests use it, and
``chip_smoke.py`` holds the kernel against it on the card.

The search has the research semantics: step 1 embeds ``<start>``; the
image enters through h0/c0 and the attention context only.  The hoisted
encoder projection ``att1 = features @ enc_w + enc_b`` is a plain product
outside the kernel, as in the JAX package.

:func:`mega_att_beam_decode` takes the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.  Launch counts:
``mega_att_beam_decode.launches`` (factored) and ``.lstm_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.att_decode_step import (K_MAX, KINDS, V_TILE,
                                                check_step_params,
                                                step_params, _kind)
from icee_tpu_torch.ops.beam import (INT_REGIONS, KC, KCP, MAX_ROWS,
                                     MAX_STAGES, NSLOT, PLAN_ARRAYS,
                                     SLOT_FLOATS, THREADS,
                                     GridPlan, Job, StagePlan, carve_regions,
                                     check_grid, grid_blocks, launch_chunks,
                                     plan_stage, plan_struct,
                                     stage_with_width, slabs_on, tail_floats)
from icee_tpu_torch.ops.decode_step import (check_beam_width,
                                            check_kernel_widths)

# csrc/grid_beam.cuh's limits for the attention (checked against the
# library when it loads)
MAX_P = 256                   # positions of an image
WARPS = THREADS // 32         # a block's warps: positions it scores at once


def _embed_table(params: dict, kind: str) -> torch.Tensor:
    return params["B"] if _kind(kind) == "factored" else params["embed"]


def mega_att_beam_decode_plain(params: dict, features: torch.Tensor,
                               style: int, batch: int, start_token: int = 1,
                               end_token: int = 2, k: int = 5,
                               max_seq_length: int = 40,
                               kind: str = "factored") -> BeamResult:
    """The search K7 runs, as ``beam_search_batched`` over
    ``factored_att_decode_step`` / ``rnn_att_decode_step`` with
    ``init_hidden_state`` on the features repeated k times."""
    att = att_mod.select_attention(params, style)
    att1 = att_mod.att_projection(att, features)
    feats_k = features.repeat_interleave(k, dim=0)
    att1_k = att1.repeat_interleave(k, dim=0)
    if _kind(kind) == "factored":
        embed_fn = lambda t: fl.embed(params, t)  # noqa: E731

        def step_fn(x, s):
            logits, _, s2 = att_mod.factored_att_decode_step(
                params, x, feats_k, s, style, att1=att1_k)
            return logits, s2
    else:
        embed_fn = lambda t: params["embed"][t.long()]  # noqa: E731

        def step_fn(x, s):
            logits, _, s2 = att_mod.rnn_att_decode_step(
                params, x, feats_k, s, att1=att1_k)
            return logits, s2
    return beam_search_batched(
        embed_fn=embed_fn, step_fn=step_fn,
        init_model_state=att_mod.init_hidden_state(params, feats_k),
        start_token=start_token, end_token=end_token, k=k,
        max_seq_length=max_seq_length,
        vocab_size=_embed_table(params, kind).shape[0], batch=batch)


def mega_att_beam_decode(params: dict, features: torch.Tensor, style: int,
                         batch: int, start_token: int = 1, end_token: int = 2,
                         k: int = 5, max_seq_length: int = 40,
                         kind: str = "factored") -> BeamResult:
    """Whole-attention-beam-search-in-one-kernel decode of ``batch`` images'
    spatial features (batch, P, FS).  ``kind="factored"`` decodes a
    StyleNet+Att tree (``style`` selects S and the attention net);
    ``kind="lstm"`` a NIC+Att tree (``style`` ignored).  Returns a
    :class:`BeamResult`, token-identical to
    :func:`mega_att_beam_decode_plain` up to float near-ties."""
    return mega_att_beam_decode_steps(params, features, style, batch,
                                      start_token, end_token, k,
                                      max_seq_length, kind)[0]


# --- the launch plan -----------------------------------------------------


@dataclass(frozen=True)
class AttGridPlan(GridPlan):
    """What one launch of ``csrc/att_beam.cu`` reads besides the tensors
    (``cell`` holds the kind): the product stages (the step's, then the
    init stage), the scores stage's ``pu`` positions a unit and ``upi``
    units an image, and the scratch layout."""
    a: int
    p: int
    fs: int
    pu: int
    upi: int


def att_stage_jobs(kind: str, e: int, f: int, h: int, v: int, a: int,
                   fs: int) -> Tuple[Tuple[Job, ...], ...]:
    """The product stages of a search, in the order ``csrc/att_beam.cu``
    lists them (and, within a stage, its job order): pre, ctx (per image),
    [vrows, style,] gates, logits, init.  The scores stage, after pre,
    has no products; the mean before init is not a product stage."""
    pre = (Job("att2", 1, a), Job("gpre", 1, fs), Job("hw", 1, 4 * h),
           Job("xpart", 1, 4 * f))
    ctx = (Job("ctx", 1, fs),)
    if kind == "factored":
        cell = ((Job("v", 1, 4 * f),), (Job("s", 4, f),),
                (Job("z", 4, h, gates=True, sets=4),))
    else:
        cell = ((Job("gates", 4, h, gates=True),),)
    return (pre, ctx, *cell, (Job("logits", 1, v),), init_stage_jobs(h))


def init_stage_jobs(h: int) -> Tuple[Job, ...]:
    """The search's last stage, run before step 1 after the mean: h0 and
    c0 from the mean feature."""
    return Job("h0", 1, h), Job("c0", 1, h)


CTX_STAGE = 1  # the per-image stage: units (slab, live image)


def plan_image_stage(jobs: Tuple[Job, ...], grid: int, n_img: int):
    """A per-image stage's slabs: units (slab, image) of the image's live
    rows (at most k), so the narrowest slabs (16, 32, 64 columns) that give
    every block about one unit, 64 once the images fill the grid so."""
    cols = n_img * sum(j.nseg * j.segw for j in jobs)
    m = -(-cols // (16 * grid))
    return stage_with_width(jobs, 16 if m <= 1 else 32 if m == 2 else 64)


def score_units(p: int, n_img: int, grid: int) -> Tuple[int, int]:
    """(positions a unit, units an image) of the scores stage: an image's P
    positions over about grid / n_img blocks, a warp's worth at least."""
    upi = max(1, min(-(-p // WARPS), grid // n_img))
    pu = -(-p // upi)
    return pu, -(-p // pu)


@functools.lru_cache(maxsize=64)
def att_grid_plan(kind: str, e: int, f: int, h: int, v: int, a: int, p: int,
                  fs: int, k: int, n_img: int, max_seq: int,
                  grid: int) -> AttGridPlan:
    """The plan of one launch for ``n_img`` images on ``grid`` blocks;
    raises ValueError on what the kernel does not take."""
    _kind(kind)
    check_kernel_widths(f, h, v, a, fs)
    if kind == "lstm" and f != h:
        raise ValueError(f"f={f} != h={h}: the LSTM cell's widths are H")
    if not 1 <= k <= min(K_MAX, v):
        raise ValueError(f"k={k} outside [1, {min(K_MAX, v)}]: the kernel "
                         "K7 (csrc/att_beam.cu) takes at most K_MAX")
    if e < 1 or n_img < 1 or max_seq < 0 or grid < 1 or a < 4 or fs < 4:
        raise ValueError(f"e={e}, n_img={n_img}, max_seq={max_seq}, "
                         f"grid={grid}, a={a}, fs={fs}: each must be "
                         "positive (a, fs at least 4)")
    if not 1 <= p <= MAX_P:
        raise ValueError(f"P={p} positions outside [1, {MAX_P}]")
    if K_MAX * a > NSLOT * SLOT_FLOATS:
        raise ValueError(f"A={a}: {K_MAX} rows of att2 do not fit the "
                         "kernel's ring")
    rows = n_img * k
    if rows > MAX_ROWS:
        raise ValueError(f"{n_img} images x k={k} = {rows} rows: one launch "
                         f"takes at most {MAX_ROWS}")
    n_tiles = -(-v // V_TILE)
    if tail_floats(n_tiles, k, max_seq + 2) > NSLOT * SLOT_FLOATS:
        raise ValueError(f"V={v}, max_seq={max_seq}: the beam tail's "
                         "scratch does not fit the kernel's ring")
    jobs = att_stage_jobs(kind, e, f, h, v, a, fs)
    stages = tuple(plan_image_stage(js, grid, n_img) if i == CTX_STAGE
                   else plan_stage(js, grid, n_img if i == len(jobs) - 1
                                   else rows)
                   for i, js in enumerate(jobs))
    pu, upi = score_units(p, n_img, grid)
    fact = kind == "factored"
    floats = carve_regions([
        ("att2", rows * a), ("gpre", rows * fs), ("hw", rows * 4 * h),
        ("xpart", rows * 4 * f), ("esc", rows * p), ("ctx", rows * fs),
        ("v", rows * 4 * f if fact else 0), ("s", rows * 4 * f if fact else 0),
        ("hn", 2 * rows * h), ("cn", 2 * rows * h),
        ("logits", rows * n_tiles * V_TILE), ("pm", rows * n_tiles),
        ("pse", rows * n_tiles), ("pv", rows * n_tiles * k),
        ("scores", rows), ("bscore", n_img), ("mean", n_img * fs)])
    ints = carve_regions([
        ("bar", 1), ("pi", rows * n_tiles * k), ("alive", rows),
        ("word", rows), ("prev", rows), ("seqs", rows * (max_seq + 2)),
        ("steps", 2 * n_img)])
    return AttGridPlan(kind, e, f, h, v, k, n_img, max_seq, grid, stages,
                       floats, ints, a, p, fs, pu, upi)


_PLAN_FIELDS = (
    "kind", "E", "F", "H", "V", "A", "P", "FS", "k", "n_img", "max_seq",
    "start", "end", "Vp", "n_tiles", "grid", "n_stages", "pu", "upi")
_FLOAT_REGIONS = ("att2", "gpre", "hw", "xpart", "esc", "ctx", "v", "s",
                  "hn", "cn", "logits", "pm", "pse", "pv", "scores",
                  "bscore", "mean")


class _CAttPlan(ctypes.Structure):
    """``csrc/att_beam.cu`` AttGridPlan, field by field (all 64-bit)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in _PLAN_FIELDS]
                + [(n, ctypes.c_longlong * MAX_STAGES) for n in PLAN_ARRAYS]
                + [("o_" + n, ctypes.c_longlong)
                   for n in _FLOAT_REGIONS + INT_REGIONS])


def _c_plan(plan: AttGridPlan, start: int, end: int) -> _CAttPlan:
    vals = dict(kind=KINDS.index(plan.cell), E=plan.e, F=plan.f, H=plan.h,
                V=plan.v, A=plan.a, P=plan.p, FS=plan.fs, k=plan.k,
                n_img=plan.n_img, max_seq=plan.max_seq, start=start, end=end,
                Vp=plan.n_tiles * V_TILE, n_tiles=plan.n_tiles,
                grid=plan.grid, n_stages=len(plan.stages), pu=plan.pu,
                upi=plan.upi)
    return plan_struct(_CAttPlan, plan, vals, _FLOAT_REGIONS + INT_REGIONS)


_max_grid: Dict[int, int] = {}


def max_grid(device: torch.device) -> int:
    """Blocks of one cooperative launch of the kernel on ``device``."""
    return grid_blocks(_library(), "icee_mega_att_beam_max_grid", _max_grid,
                       device)


def mega_att_beam_decode_steps(
        params: dict, features: torch.Tensor, style: int, batch: int,
        start_token: int = 1, end_token: int = 2, k: int = 5,
        max_seq_length: int = 40, kind: str = "factored",
        grid: Optional[int] = None
) -> Tuple[BeamResult, Optional[torch.Tensor]]:
    """:func:`mega_att_beam_decode`, plus a (batch, 2) int32 count per
    image: the steps it ran before its last beam ended, and the live
    row-steps (beams computed, summed over those steps), which size the
    work for a bound (None from the plain version on the CPU).  ``grid``
    launches fewer blocks than the card holds (tests: the bits must not
    change)."""
    result, steps, _ = _search(params, features, style, batch, start_token,
                               end_token, k, max_seq_length, kind, grid)
    return result, steps


def _search(params: dict, features: torch.Tensor, style: int, batch: int,
            start_token: int, end_token: int, k: int, max_seq_length: int,
            kind: str, grid: Optional[int]):
    """:func:`mega_att_beam_decode_steps`, plus each launch's (plan,
    scratch) on the card (an empty list on the CPU)."""
    emb = _embed_table(params, kind)
    device = emb.device
    v, e = emb.shape
    if kind == "factored" and not 0 <= int(style) < params["S_w"].shape[0]:
        raise ValueError(f"style {style} outside [0, {params['S_w'].shape[0]})")
    cell, att, gate = step_params(params, kind, style)
    fs = gate["f_beta_w"].shape[1]
    f, hd, v, a, fs = check_step_params(cell, att, gate, kind, e + fs, device)
    p = features.shape[1] if features.dim() == 3 else -1
    cuda_lib.check_tensor("features", features, (batch, p, fs),
                          torch.float32, device)
    for name, shape in (("init_h_w", (fs, hd)), ("init_h_b", (hd,)),
                        ("init_c_w", (fs, hd)), ("init_c_b", (hd,))):
        cuda_lib.check_tensor(name, params[name], shape, torch.float32,
                              device)
    check_beam_width("k", k, v, device, "K7 (csrc/att_beam.cu)")
    if device.type == "cpu":
        return mega_att_beam_decode_plain(params, features, int(style), batch,
                                          start_token, end_token, k,
                                          max_seq_length, kind), None, []
    if device.type != "cuda":
        raise ValueError(f"mega_att_beam_decode: unsupported device {device}")
    check_kernel_widths(f, hd, v, a, fs)
    lib = _library()
    blocks = check_grid(grid, max_grid(device))
    att1 = att_mod.att_projection(att, features)
    ptr = cuda_lib.ptr
    names = (("V_w", "V_b", "S_w", "S_b", "U_w", "U_b", "W_w", "W_b")
             if kind == "factored" else ("W_ih", "b_ih", "W_hh", "b_hh"))
    weights = (ptr(emb), ptr(att["dec_w"]), ptr(att["dec_b"]),
               ptr(att["full_w"]), ptr(att["full_b"]), ptr(gate["f_beta_w"]),
               ptr(gate["f_beta_b"]),
               *(ptr(params[n]) for n in ("init_h_w", "init_h_b", "init_c_w",
                                          "init_c_b")),
               *(ptr(cell[n]) for n in names), ptr(cell["C_w"]),
               ptr(cell["C_b"]))
    fn = (lib.icee_mega_att_beam_decode if kind == "factored"
          else lib.icee_mega_att_beam_decode_lstm)
    i32 = dict(dtype=torch.int32, device=device)
    results, launched = [], []
    for first, n_img in launch_chunks(batch, k):
        plan = att_grid_plan(kind, e, f, hd, v, a, p, fs, k, n_img,
                             max_seq_length, blocks)
        scratch = torch.empty((plan.n_floats,), dtype=torch.float32,
                              device=device)
        ints = torch.zeros((plan.n_ints,), **i32)  # the barrier starts at 0
        tokens = torch.empty((n_img, max_seq_length + 2), **i32)
        length = torch.empty((n_img,), **i32)
        score = torch.empty((n_img,), dtype=torch.float32, device=device)
        cplan = _c_plan(plan, start_token, end_token)
        rc = fn(ctypes.byref(cplan), ptr(slabs_on(plan, device)),
                ptr(features[first:first + n_img]),
                ptr(att1[first:first + n_img]), *weights, ptr(scratch),
                ptr(ints), ptr(tokens), ptr(length), ptr(score),
                cuda_lib.stream_ptr(device))
        cuda_lib.check_rc(lib, rc, f"mega_att_beam_decode (kind={kind})")
        if kind == "factored":
            mega_att_beam_decode.launches += 1
        else:
            mega_att_beam_decode.lstm_launches += 1
        off, size = plan.region("steps")
        results.append((tokens, length, score,
                        ints[off:off + size].view(n_img, 2).clone()))
        launched.append((plan, scratch))
    if len(results) == 1:
        tokens, length, score, steps = results[0]
    else:
        tokens, length, score, steps = (torch.cat(t) for t in zip(*results))
    return (BeamResult(tokens=tokens, length=length, score=score), steps,
            launched)


def search_init_state(params: dict, features: torch.Tensor,
                      kind: str = "factored", style: int = 0, k: int = 5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h0, c0 (n_img, H) as the search computes them before its first
    step, on the card: a search of ``max_seq_length=0`` leaves them in the
    parity-1 h and c planes of its scratch (row img * k), which step 1
    reads and no later step overwrote.  For holding :func:`init_state`
    to the search; None, None on the CPU."""
    n_img = features.shape[0]
    _, _, launched = _search(params, features, style, n_img, 1, 2, k, 0,
                             kind, None)
    if not launched:
        return None, None
    hd = params["init_h_w"].shape[1]
    out = []
    for name in ("hn", "cn"):
        parts = []
        for plan, scratch in launched:
            off, _ = plan.region(name)
            plane = scratch[off + plan.rows * hd:off + 2 * plan.rows * hd]
            parts.append(plane.view(plan.n_img, plan.k, hd)[:, 0])
        out.append(torch.cat(parts))
    return out[0], out[1]


# --- the search's h0/c0 alone (the fused-step path's start) ---------------


@dataclass(frozen=True)
class AttInitPlan:
    """What one h0/c0 launch of ``csrc/att_beam.cu``
    (``icee_att_init_state``) reads besides the tensors: for ``n_img``
    images on ``grid`` blocks, the search's init stage (its one product
    stage; the mean before it is ``run_mean``, a thread an (image, column
    quad)) and the scratch (the mean)."""
    h: int
    p: int
    fs: int
    n_img: int
    grid: int
    stages: Tuple[StagePlan, ...]
    floats: Tuple[Tuple[str, int, int], ...]
    ints: Tuple[Tuple[str, int, int], ...] = ()

    region = GridPlan.region
    slab_table = GridPlan.slab_table
    n_floats = GridPlan.n_floats


@functools.lru_cache(maxsize=64)
def att_init_plan(h: int, p: int, fs: int, n_img: int,
                  grid: int) -> AttInitPlan:
    """The plan of one h0/c0 launch: the search's init stage planned as
    :func:`att_grid_plan` plans it (units (column slab, image block));
    raises ValueError on what the kernel does not take."""
    check_kernel_widths(h, fs)
    if p < 1 or n_img < 1 or grid < 1 or h < 4 or fs < 4:
        raise ValueError(f"P={p}, n_img={n_img}, grid={grid}, h={h}, "
                         f"fs={fs}: each must be positive (h, fs at least 4)")
    if n_img > MAX_ROWS:
        raise ValueError(f"{n_img} images: one launch takes at most "
                         f"{MAX_ROWS}")
    return AttInitPlan(h, p, fs, n_img, grid,
                       (plan_stage(init_stage_jobs(h), grid, n_img),),
                       carve_regions([("mean", n_img * fs)]))


class _CInitPlan(ctypes.Structure):
    """``csrc/att_beam.cu`` AttInitPlan, field by field (all 64-bit)."""
    _fields_ = ([(n, ctypes.c_longlong)
                 for n in ("H", "P", "FS", "n_img", "grid", "n_stages")]
                + [(n, ctypes.c_longlong * MAX_STAGES) for n in PLAN_ARRAYS]
                + [("o_mean", ctypes.c_longlong)])


_init_cplans: Dict[AttInitPlan, _CInitPlan] = {}


def init_state(params: dict, features: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h0, c0 (n_img, H) of the search from ``features`` (n_img, P, FS)
    on the card, by the search's own mean and init stage over the whole
    card (``icee_att_init_state``, two launches): the same bits as the
    search's.  The caller (``att_decode_step.att_init_state``) validates
    the tensors."""
    device = features.device
    n_all, p, fs = features.shape
    hd = params["init_h_w"].shape[1]
    lib = _library()
    blocks = max_grid(device)
    f32 = dict(dtype=torch.float32, device=device)
    h0 = torch.empty((n_all, hd), **f32)
    c0 = torch.empty_like(h0)
    ptr = cuda_lib.ptr
    weights = [ptr(params[n]) for n in ("init_h_w", "init_h_b", "init_c_w",
                                        "init_c_b")]
    for first, n_img in launch_chunks(n_all, 1):
        plan = att_init_plan(hd, p, fs, n_img, blocks)
        scratch = torch.empty((plan.n_floats,), **f32)
        cplan = _init_cplans.get(plan)
        if cplan is None:
            if len(_init_cplans) >= 64:
                _init_cplans.clear()
            cplan = _init_cplans[plan] = plan_struct(_CInitPlan, plan, dict(
                H=hd, P=p, FS=fs, n_img=n_img, grid=blocks, n_stages=1),
                ("mean",))
        rc = lib.icee_att_init_state(
            ctypes.byref(cplan), ptr(slabs_on(plan, device)),
            ptr(features[first:first + n_img]), *weights,
            ptr(h0[first:first + n_img]), ptr(c0[first:first + n_img]),
            ptr(scratch), cuda_lib.stream_ptr(device))
        cuda_lib.check_rc(lib, rc, "att_init_state")
    return h0, c0


mega_att_beam_decode.launches = 0       # kernel launches, kind="factored"
mega_att_beam_decode.lstm_launches = 0  # kernel launches, kind="lstm"


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = cuda_lib.library("att_beam", {
        "icee_mega_att_beam_decode": ([vp] * 31, i),
        "icee_mega_att_beam_decode_lstm": ([vp] * 27, i),
        "icee_mega_att_beam_max_grid": ([vp], i),
        "icee_att_init_state": ([vp] * 11, i),
        "icee_mega_att_beam_consts": ([vp], None)})
    if getattr(lib, "geometry_checked", False):
        return lib
    consts = (ctypes.c_longlong * 9)()
    lib.icee_mega_att_beam_consts(consts)
    want = (THREADS, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS, MAX_P, K_MAX)
    if tuple(consts[1:]) != want:
        raise RuntimeError(f"csrc/att_beam.cu's geometry {tuple(consts[1:])} "
                           f"is not the wrapper's {want}")
    lib.geometry_checked = True
    return lib
