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
kernel reads.  Beam widths above 8, up to V: the per-image stages take
an image's live rows in groups of up to 8 (``ATT_GROUP`` rows, a group
planned in an image's place), and the selection is K2's wide row stage
and tail (``ops/beam.py::selection_kind``: also at k <= 8 where the
narrow tail outgrows the ring; above 256 with the survivors, and past
``MAX_ROWS`` rows the row lists, in device memory).  :func:`init_state` runs the search's mean and h0/c0 stage
alone for the fused-step path (``att_decode_step.att_init_state``),
planned by :func:`att_init_plan`.  Any P and A (:func:`alpha_layout`):
a unit's softmax rows sit in shared memory while they fit beside the ring
(P to 1,784), past that a softmax stage of their own turns each row of
scores into alpha in place in device memory and the context stage streams
them; the scores stage stages att2 in the ring to A = 3,840 and reads it
from L2 past that.  The TPU scheduling knobs
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
``mega_att_beam_decode.launches`` (factored) and ``.lstm_launches``, and of
those with the wide selection ``.wide_launches`` and
``.lstm_wide_launches``.
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
from icee_tpu_torch.ops import cuda_lib, widths
from icee_tpu_torch.ops.att_decode_step import (ATT_WEIGHTS, CELL_WEIGHTS,
                                                GATE_WEIGHTS, K_MAX, KINDS,
                                                V_TILE, check_step_params,
                                                step_layout, step_params,
                                                _kind)
from icee_tpu_torch.ops.beam import (INT_REGIONS, KC, KCP, MAX_K, MAX_ROWS,
                                     MAX_STAGES, NSLOT, PLAN_ARRAYS,
                                     SEL_NARROW, SLOT_FLOATS, THREADS,
                                     TILE_ARRAYS, GridPlan, Job, StagePlan,
                                     TilePlan, carve_regions, check_grid,
                                     check_plan_rows, check_plan_width,
                                     check_ring, grid_blocks, launch_chunks,
                                     plan_stage, plan_struct, plan_tiles,
                                     scan_regions, selection_regions,
                                     stage_with_width, slabs_on)
from icee_tpu_torch.ops.decode_step import K_WIDE, check_beam_width

# csrc/grid_beam.cuh's geometry for the attention (checked against the
# library when it loads)
MAX_P = 256                   # positions whose softmax rows sit at ALD
ALD = MAX_P + 4               # their row stride in shared memory
GRID_SMEM_MAX = 229376        # dynamic shared memory a search block takes
ZS_FLOATS = 64 * 64           # a gate unit's z exchange
WARPS = THREADS // 32         # a block's warps: positions it scores at once
ATT_GROUP = K_MAX             # rows of a per-image unit: a wider beam's
                              # image takes ceil(k / 8) units' places


def grid_smem(ald: int) -> int:
    """Bytes of dynamic shared memory of a search block whose softmax rows
    are ``ald`` floats apart (``csrc/grid_beam.cuh`` ``grid_smem_bytes``):
    the ring, the z exchange, 8 softmax rows, the row lists."""
    return (4 * (NSLOT * SLOT_FLOATS + ZS_FLOATS + K_MAX * ald)
            + 8 * MAX_ROWS + 4 * (6 * MAX_ROWS + 32))


def alpha_layout(p: int, a: int) -> Tuple[int, int, bool]:
    """Where a search over ``p`` positions at (padded) attention width
    ``a`` keeps what its per-image stages read (``csrc/att_beam.cu``
    ``alpha_layout``): (the softmax rows' stride in shared memory, the
    attention scores' row stride, whether the scores stage stages att2 in
    the ring).  The stride is ``ALD`` to ``MAX_P`` positions (the launch as
    it was), round4(P) + 4 while the block's shared memory holds 8 such
    rows beside the ring (P to 1,784), else 0: each row's softmax in place
    in the scores (device memory, rows round4(P) apart) by a stage of its
    own.  att2 rows stage in the ring while 8 of them fit (A to 3,840),
    else the scores stage reads them from L2."""
    ald = ALD if p <= MAX_P else widths.quad(p) + 4
    if grid_smem(ald) > GRID_SMEM_MAX:
        ald = 0
    return ald, p if ald else widths.quad(p), K_MAX * widths.quad(a) <= \
        NSLOT * SLOT_FLOATS


def image_groups(n_img: int, k: int) -> int:
    """The per-image stages' units of rows: an image's k rows in groups of
    at most ``ATT_GROUP`` (one an image where k <= ``K_MAX``)."""
    return n_img * -(-k // ATT_GROUP)


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
    :func:`mega_att_beam_decode_plain` up to float near-ties.  Any F, H, V,
    A and FS: on the card the kernel reads the weights, the features and
    att1 at widths rounded up to 4 (``ops/widths.py``)."""
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

    @property
    def alpha(self) -> Tuple[int, int, bool]:
        """(softmax rows' stride in shared memory, 0: in device memory;
        the scores' row stride; att2 staged in the ring):
        :func:`alpha_layout`."""
        return alpha_layout(self.p, self.a)

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory of a block of the launch."""
        return grid_smem(self.alpha[0])


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
    rows (at most min(k, 8); ``n_img`` counts an image's groups where k is
    wider, :func:`image_groups`), so the narrowest slabs (16, 32, 64
    columns) that give every block about one unit, 64 once the images fill
    the grid so."""
    cols = n_img * sum(j.nseg * j.segw for j in jobs)
    m = -(-cols // (16 * grid))
    return stage_with_width(jobs, 16 if m <= 1 else 32 if m == 2 else 64)


def score_units(p: int, n_img: int, grid: int) -> Tuple[int, int]:
    """(positions a unit, units an image) of the scores stage: an image's P
    positions over about grid / n_img blocks, a warp's worth at least
    (``n_img`` counts groups as :func:`plan_image_stage` does)."""
    upi = max(1, min(-(-p // WARPS), grid // n_img))
    pu = -(-p // upi)
    return pu, -(-p // pu)


@functools.lru_cache(maxsize=64)
def att_grid_plan(kind: str, e: int, f: int, h: int, v: int, a: int, p: int,
                  fs: int, k: int, n_img: int, max_seq: int,
                  grid: int) -> AttGridPlan:
    """The plan of one launch for ``n_img`` images on ``grid`` blocks, at
    F, H, V, A and FS rounded up to 4 (the padded layout the kernel reads,
    ``ops/widths.py``: the plan's widths); raises ValueError on what the
    kernel does not take."""
    _kind(kind)
    if kind == "lstm" and f != h:
        raise ValueError(f"f={f} != h={h}: the LSTM cell's widths are H")
    check_plan_width("K7 (csrc/att_beam.cu)", k, v)
    if e < 1 or n_img < 1 or max_seq < 0 or grid < 1 or a < 1 or fs < 1:
        raise ValueError(f"e={e}, n_img={n_img}, max_seq={max_seq}, "
                         f"grid={grid}, a={a}, fs={fs}: each must be "
                         "positive")
    f, h, v, a, fs = map(widths.quad, (f, h, v, a, fs))
    if p < 1:
        raise ValueError(f"P={p} positions: at least 1")
    rows = n_img * k
    check_plan_rows(n_img, k)
    n_tiles = -(-v // V_TILE)
    check_ring(n_tiles, k, v, max_seq)
    jobs = att_stage_jobs(kind, e, f, h, v, a, fs)
    groups = image_groups(n_img, k)
    stage_rows = [n_img if i == len(jobs) - 1 else rows
                  for i in range(len(jobs))]
    stages = tuple(plan_image_stage(js, grid, groups) if i == CTX_STAGE
                   else plan_stage(js, grid, stage_rows[i])
                   for i, js in enumerate(jobs))
    # the per-image stage keeps its slabs
    tiles = tuple(TilePlan() if i == CTX_STAGE
                  else plan_tiles(st, grid, stage_rows[i])
                  for i, st in enumerate(stages))
    pu, upi = score_units(p, groups, grid)
    fact = kind == "factored"
    sel = selection_regions(rows, n_tiles, k, max_seq + 2)
    floats = carve_regions([
        ("att2", rows * a), ("gpre", rows * fs), ("hw", rows * 4 * h),
        ("xpart", rows * 4 * f), ("esc", rows * alpha_layout(p, a)[1]),
        ("ctx", rows * fs),
        ("v", rows * 4 * f if fact else 0), ("s", rows * 4 * f if fact else 0),
        ("hn", 2 * rows * h), ("cn", 2 * rows * h),
        ("logits", rows * n_tiles * V_TILE), ("pm", sel["pm"]),
        ("pse", sel["pse"]), ("pv", sel["pv"]),
        ("scores", rows), ("bscore", n_img), ("mean", n_img * fs)])
    ints = carve_regions([
        ("bar", 1), ("pi", sel["pi"]), ("alive", rows), ("word", rows),
        ("prev", rows), ("seqs", sel["seqs"]), ("steps", 2 * n_img)]
        + (scan_regions(rows, k, grid) if k > K_WIDE else []))
    return AttGridPlan(kind, e, f, h, v, k, n_img, max_seq, grid, stages,
                       floats, ints, tiles, a, p, fs, pu, upi)


_PLAN_FIELDS = (
    "kind", "E", "F", "H", "V", "A", "P", "FS", "k", "n_img", "max_seq",
    "start", "end", "Vp", "n_tiles", "grid", "n_stages", "pu", "upi")
_FLOAT_REGIONS = ("att2", "gpre", "hw", "xpart", "esc", "ctx", "v", "s",
                  "hn", "cn", "logits", "pm", "pse", "pv", "scores",
                  "bscore", "mean")


class _CAttPlan(ctypes.Structure):
    """``csrc/att_beam.cu`` AttGridPlan, field by field (all 64-bit)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in _PLAN_FIELDS]
                + [(n, ctypes.c_longlong * MAX_STAGES)
                   for n in PLAN_ARRAYS + TILE_ARRAYS]
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
    check_beam_width("k", k, v)
    if device.type == "cpu":
        return mega_att_beam_decode_plain(params, features, int(style), batch,
                                          start_token, end_token, k,
                                          max_seq_length, kind), None, []
    if device.type != "cuda":
        raise ValueError(f"mega_att_beam_decode: unsupported device {device}")
    lib = _library()
    blocks = check_grid(grid, max_grid(device))
    w, held = cuda_lib.checked_weights(
        decoder_trees(params), ("K7", kind, int(style), device),
        lambda: _search_weights(params, kind, int(style), e))
    ptr = cuda_lib.ptr
    att1 = widths.pad_last(att_mod.att_projection(att, features),
                           w["A"][1])
    features = widths.pad_last(features, w["FS"][1])
    weights = (ptr(emb), *held[0])
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
        prefix = "" if kind == "factored" else "lstm_"
        mega_att_beam_decode.__dict__[prefix + "launches"] += 1
        mega_att_beam_decode.__dict__[prefix + "wide_launches"] += (
            plan.selection != SEL_NARROW)
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


INIT_WEIGHTS = ("init_h_w", "init_h_b", "init_c_w", "init_c_b")


def decoder_trees(params: dict) -> Tuple[dict, ...]:
    """An attention decoder's tree and the trees nested in it (the
    attention nets, the LSTM cell), whose tensors key its padded copy."""
    return (params, *(t for t in params.values() if isinstance(t, dict)))


def init_layout(params: dict, fs: int) -> Tuple[widths.Widths, dict]:
    """The h0/c0 weights (``INIT_WEIGHTS``) at H and FS rounded up to 4,
    and their widths (``ops/widths.py``)."""
    w = widths.widths(H=params["init_h_w"].shape[1], FS=fs)
    return w, widths.pad_tree({n: params[n] for n in INIT_WEIGHTS}, w)


def search_layout(params: dict, kind: str, style: int,
                  e: int) -> Tuple[widths.Widths, dict]:
    """K7's launch setup: the widths (true, padded) and the weights the
    kernel reads (the style's step trees as K6 takes them, and the h0/c0
    weights) laid out at the padded widths."""
    cell, att, gate = step_params(params, kind, style)
    w, kern = step_layout(cell, att, gate, kind, e)
    kern.update(init_layout(params, w["FS"][0])[1])
    return w, kern


def _search_weights(params: dict, kind: str, style: int, e: int):
    """-> (widths, (the kernel's weight arguments after the embedding, the
    padded tensors they point into))."""
    w, kern = search_layout(params, kind, style, e)
    names = (ATT_WEIGHTS + GATE_WEIGHTS + INIT_WEIGHTS + CELL_WEIGHTS[kind]
             + ("C_w", "C_b"))
    held = (tuple(cuda_lib.ptr(kern[n]) for n in names), kern)
    return widths.checked(w, held)


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
            plane = scratch[off + plan.rows * plan.h:
                            off + 2 * plan.rows * plan.h]
            parts.append(plane.view(plan.n_img, plan.k, plan.h)[:, 0, :hd])
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
    tiles = ()   # the h0/c0 launch's stage keeps its slabs

    region = GridPlan.region
    slab_table = GridPlan.slab_table
    n_floats = GridPlan.n_floats


@functools.lru_cache(maxsize=64)
def att_init_plan(h: int, p: int, fs: int, n_img: int,
                  grid: int) -> AttInitPlan:
    """The plan of one h0/c0 launch: the search's init stage planned as
    :func:`att_grid_plan` plans it (units (column slab, image block)), at
    H and FS rounded up to 4; raises ValueError on what the kernel does
    not take."""
    if p < 1 or n_img < 1 or grid < 1 or h < 1 or fs < 1:
        raise ValueError(f"P={p}, n_img={n_img}, grid={grid}, h={h}, "
                         f"fs={fs}: each must be positive")
    h, fs = widths.quad(h), widths.quad(fs)
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
    w, kern = cuda_lib.checked_weights(
        (params,), ("init", fs, device),
        lambda: widths.checked(*init_layout(params, fs)))
    hp, fsp = w["H"][1], w["FS"][1]
    features = widths.pad_last(features, fsp)
    f32 = dict(dtype=torch.float32, device=device)
    h0 = torch.empty((n_all, hp), **f32)
    c0 = torch.empty_like(h0)
    ptr = cuda_lib.ptr
    weights = [ptr(kern[n]) for n in INIT_WEIGHTS]
    for first, n_img in launch_chunks(n_all, 1):
        plan = att_init_plan(hd, p, fs, n_img, blocks)
        scratch = torch.empty((plan.n_floats,), **f32)
        cplan = _init_cplans.get(plan)
        if cplan is None:
            if len(_init_cplans) >= 64:
                _init_cplans.clear()
            cplan = _init_cplans[plan] = plan_struct(_CInitPlan, plan, dict(
                H=hp, P=p, FS=fsp, n_img=n_img, grid=blocks, n_stages=1),
                ("mean",))
        rc = lib.icee_att_init_state(
            ctypes.byref(cplan), ptr(slabs_on(plan, device)),
            ptr(features[first:first + n_img]), *weights,
            ptr(h0[first:first + n_img]), ptr(c0[first:first + n_img]),
            ptr(scratch), cuda_lib.stream_ptr(device))
        cuda_lib.check_rc(lib, rc, "att_init_state")
    return widths.cut_last(h0, hd), widths.cut_last(c0, hd)


mega_att_beam_decode.launches = 0       # kernel launches, kind="factored"
mega_att_beam_decode.lstm_launches = 0  # kernel launches, kind="lstm"
mega_att_beam_decode.wide_launches = 0       # of those, the wide selection
mega_att_beam_decode.lstm_wide_launches = 0


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = cuda_lib.library("att_beam", {
        "icee_mega_att_beam_decode": ([vp] * 31, i),
        "icee_mega_att_beam_decode_lstm": ([vp] * 27, i),
        "icee_mega_att_beam_max_grid": ([vp], i),
        "icee_att_init_state": ([vp] * 11, i),
        "icee_mega_att_beam_consts": ([vp], None),
        "icee_mega_att_beam_layout": ([i, i, vp], None),
        "icee_grid_profile": ([i, vp], i),
        "icee_grid_records": ([vp, i, vp], i)})
    if getattr(lib, "geometry_checked", False):
        return lib
    consts = (ctypes.c_longlong * 11)()
    lib.icee_mega_att_beam_consts(consts)
    want = (THREADS, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS, MAX_P, K_MAX,
            K_WIDE, MAX_K)
    if tuple(consts[1:]) != want or consts[0] != grid_smem(ALD):
        raise RuntimeError(f"csrc/att_beam.cu's geometry {tuple(consts)} "
                           f"is not the wrapper's {(grid_smem(ALD), *want)}")
    for p in LAYOUT_PS:
        for a in (4, 512, 3840, 3844, 4096):
            out = (ctypes.c_longlong * 4)()
            lib.icee_mega_att_beam_layout(p, a, out)
            ald, eld, ring = alpha_layout(p, a)
            if tuple(out) != (ald, eld, int(ring), grid_smem(ald)):
                raise RuntimeError(
                    f"csrc/att_beam.cu's alpha layout {tuple(out)} at P={p}, "
                    f"A={a} is not the wrapper's "
                    f"{(ald, eld, int(ring), grid_smem(ald))}")
    lib.geometry_checked = True
    return lib


# P at which the library's alpha layout is held to alpha_layout when it
# loads: each side of both of its boundaries, the grids users run
LAYOUT_PS = (1, 49, 196, 256, 257, 289, 400, 1024, 1781, 1784, 1785, 2304,
             4096)
