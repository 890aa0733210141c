"""K2: the whole k-beam search in one launch, for the StyleNet FactoredLSTM
(``cell="factored"``) or the NIC decoder (``cell="lstm"``).

Port of ``icee_tpu/ops/pallas_beam.py::mega_beam_decode``.  The CUDA kernel
is ``csrc/beam.cu`` (its machinery, shared with K7, in
``csrc/grid_beam.cuh``): ONE cooperative launch of one block per SM, persistent
over every step, spreads each step of the search over the whole card.  A
step runs as stages separated by a grid barrier: the cell's products (their
output columns cut into slabs, the live rows into blocks), the vocabulary
head, the per-tile top-k partials, and each image's beam tail (merge,
selection, sequences, best-completed tracking, early exit).  Only the beams
still alive run.  :func:`grid_plan` is the launch plan the kernel reads:
each stage's column slabs and row-block size, and the scratch layout.

:func:`mega_beam_decode_plain` is the same search in plain PyTorch
(:func:`~icee_tpu_torch.decode.beam.beam_search_batched` over the decoder's
full-vocabulary step): the CPU tests use it, and ``chip_smoke.py`` holds the
kernel against it on the card.

:func:`mega_beam_decode` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Its launch counts
are ``mega_beam_decode.launches`` (factored) and
``mega_beam_decode.lstm_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.decode_step import (K_MAX, V_TILE,
                                            check_beam_width,
                                            check_decoder_params,
                                            check_kernel_widths)

CELLS = ("factored", "lstm")
# csrc/grid_beam.cuh's geometry (checked against the library when it loads)
THREADS = 512        # a block's threads
KC = 64              # k rows of a ring chunk
KCP = KC + 4         # row stride of a chunk's input rows
NSLOT = 4            # ring chunks
SLOT_FLOATS = 7680   # floats of one chunk: weights, then input rows
MAX_ROWS = 1024      # rows (images x k) of one launch
MAX_BR = 64          # most rows of a unit
MAX_UNIT_ROWS = 128  # input rows of a unit, all sets (two a copying thread)
MAX_STAGES = 8
SCRATCH_ALIGN = 64   # floats: each scratch region starts 256-byte aligned


def check_nic_params(params: dict, device: torch.device) -> Tuple[int, ...]:
    """Validate the NIC decoder tensors the kernel reads; -> (E, H, V)."""
    v, e = params["embed"].shape
    h = params["cell"]["W_hh"].shape[0]
    shapes = {"embed": (v, e), "W_ih": (e, 4 * h), "b_ih": (4 * h,),
              "W_hh": (h, 4 * h), "b_hh": (4 * h,), "linear_w": (h, v),
              "linear_b": (v,)}
    for name, shape in shapes.items():
        t = params["cell"][name] if name in params["cell"] else params[name]
        cuda_lib.check_tensor(name, t, shape, torch.float32, device)
    return e, h, v


def _head(params: dict, cell: str) -> torch.Tensor:
    if cell not in CELLS:
        raise ValueError(f"unknown cell {cell!r}; choose one of {CELLS}")
    return params["C_w"] if cell == "factored" else params["linear_w"]


def mega_beam_decode_plain(params: dict, features: Optional[torch.Tensor],
                           style: int, batch: int, start_token: int = 1,
                           end_token: int = 2, k: int = 5,
                           max_seq_length: int = 40,
                           cell: str = "factored") -> BeamResult:
    """The search K2 runs, as ``beam_search_batched`` over
    ``factored_lstm.decode_step`` or ``lstm.decode_step`` (which ignores
    ``style``); ``features`` None is research mode."""
    head = _head(params, cell)
    zeros = torch.zeros((batch * k, head.shape[0]), dtype=head.dtype,
                        device=head.device)
    if cell == "factored":
        embed_fn = lambda t: fl.embed(params, t)  # noqa: E731
        step_fn = lambda x, s: fl.decode_step(params, x, s, style)  # noqa: E731
    else:
        embed_fn = lambda t: nic.embed(params, t)  # noqa: E731
        step_fn = lambda x, s: nic.decode_step(params, x, s)  # noqa: E731
    return beam_search_batched(
        embed_fn=embed_fn, step_fn=step_fn,
        init_model_state=(zeros, zeros.clone()),
        start_token=start_token, end_token=end_token, k=k,
        max_seq_length=max_seq_length, vocab_size=head.shape[1],
        batch=batch, first_input=features)


def mega_beam_decode(params: dict, features: Optional[torch.Tensor],
                     style: int, batch: int, start_token: int = 1,
                     end_token: int = 2, k: int = 5,
                     max_seq_length: int = 40,
                     cell: str = "factored") -> BeamResult:
    """Whole-beam-search-in-one-kernel decode for ``batch`` images.

    ``features``: (batch, k, E) step-1 inputs (serving semantics), or None
    for research semantics (``<start>``'s embedding at step 1).
    ``cell="lstm"`` decodes the NIC parameter tree and ignores ``style``.
    Returns a :class:`BeamResult` with a leading batch dim, token-identical
    to :func:`mega_beam_decode_plain`.
    """
    return mega_beam_decode_steps(params, features, style, batch,
                                  start_token, end_token, k,
                                  max_seq_length, cell)[0]


# --- the launch plan -----------------------------------------------------


@dataclass(frozen=True)
class Job:
    """One product of a stage (``csrc/beam.cu`` Job): ``nseg`` segments of
    ``segw`` output columns.  A gate product's slab holds the same columns
    of all four segments (gates); ``sets`` input-row sets a chunk holds
    (4 where each gate reads its own segment of the input)."""
    name: str
    nseg: int
    segw: int
    gates: bool = False
    sets: int = 1


@dataclass(frozen=True)
class StagePlan:
    jobs: Tuple[Job, ...]
    cw: int     # columns of a slab (a gate slab: cw // 4 of each gate)
    br: int     # most live rows of a unit
    slabs: Tuple[Tuple[int, int, int, int], ...]  # (job, seg, col0, width)


@dataclass(frozen=True)
class GridPlan:
    """What one launch of ``csrc/beam.cu`` reads besides the tensors: the
    product stages and the scratch layout (float and int regions, each
    ``(offset, size)`` in elements)."""
    cell: str
    e: int
    f: int
    h: int
    v: int
    k: int
    n_img: int
    max_seq: int
    grid: int
    stages: Tuple[StagePlan, ...]
    floats: Tuple[Tuple[str, int, int], ...]
    ints: Tuple[Tuple[str, int, int], ...]

    @property
    def rows(self) -> int:
        return self.n_img * self.k

    @property
    def n_tiles(self) -> int:
        return -(-self.v // V_TILE)

    @property
    def n_floats(self) -> int:
        return _end(self.floats)

    @property
    def n_ints(self) -> int:
        return _end(self.ints)

    def region(self, name: str) -> Tuple[int, int]:
        for n, off, size in self.floats + self.ints:
            if n == name:
                return off, size
        raise KeyError(name)

    def slab_table(self) -> np.ndarray:
        """(slabs, 4) int32: every stage's slabs in turn."""
        return np.asarray([s for st in self.stages for s in st.slabs],
                          dtype=np.int32).reshape(-1, 4)


def _end(regions) -> int:
    return max(off + size for _, off, size in regions)


def stage_jobs(cell: str, e: int, f: int, h: int,
               v: int) -> Tuple[Tuple[Job, ...], ...]:
    """The product stages of a step, in the order ``csrc/beam.cu`` runs
    them (and, within a stage, its Job order)."""
    head = (Job("logits", 1, v),)
    if cell == "factored":
        return ((Job("v", 1, 4 * f), Job("hw", 1, 4 * h)),
                (Job("s", 4, f),),
                (Job("z", 4, h, gates=True, sets=4),),
                head)
    return ((Job("gates", 4, h, gates=True),), head)


def plan_stage(jobs: Tuple[Job, ...], grid: int, rows: int) -> StagePlan:
    """The stage's slabs for ``rows`` live rows on ``grid`` blocks: 64
    columns wide where units of all the rows still number a block each or
    more (each input row is then read by the fewest slabs, and a thread
    runs two rows), else about one slab a block, 16, 32 or 64 columns (the
    narrowest that cover the stage in one slab a block: at a few rows a
    step is the chains' latency, so every block gets a slab)."""
    wide = stage_with_width(jobs, 64)
    if len(wide.slabs) * -(-rows // wide.br) >= grid:
        return wide
    cols = sum(j.nseg * j.segw for j in jobs)
    m = -(-cols // (16 * grid))
    return stage_with_width(jobs, 16 if m <= 1 else 32 if m == 2 else 64)


def stage_with_width(jobs: Tuple[Job, ...], cw: int) -> StagePlan:
    """The stage's slabs ``cw`` columns wide, and its row block."""
    lanes = THREADS // (cw // 4)
    sets = max(j.sets for j in jobs)
    br = min(MAX_BR, 2 * lanes, (SLOT_FLOATS - KC * cw) // (sets * KCP),
             MAX_UNIT_ROWS // sets)
    slabs = []
    for ji, j in enumerate(jobs):
        if j.gates:
            w = cw // 4
            slabs += [(ji, 0, c0, min(w, j.segw - c0))
                      for c0 in range(0, j.segw, w)]
        else:
            slabs += [(ji, seg, c0, min(cw, j.segw - c0))
                      for seg in range(j.nseg)
                      for c0 in range(0, j.segw, cw)]
    return StagePlan(jobs, cw, br, tuple(slabs))


def slab_columns(stage: StagePlan, job: int) -> list:
    """The output columns of ``job`` that the stage's slabs cover, in
    slab order (a gate slab: gate by gate)."""
    j = stage.jobs[job]
    cols = []
    for ji, seg, c0, width in stage.slabs:
        if ji != job:
            continue
        for g in (range(j.nseg) if j.gates else (seg,)):
            cols += range(g * j.segw + c0, g * j.segw + c0 + width)
    return cols


def merge_floats(n_tiles: int, k: int) -> int:
    """Floats of one merging warp's copy of a row's partials (beam.cu)."""
    return (n_tiles * (2 + 2 * k) + 3) & ~3


def tail_floats(n_tiles: int, k: int, length: int) -> int:
    """Floats of the beam tail's scratch (beam.cu): K_MAX merging warps'
    copies, then one image's log-probs, ids, sequences and slot state."""
    return (K_MAX * merge_floats(n_tiles, k) + 2 * k * k + 2 * k * length
            + 6 * k + 4)


def carve_regions(sizes) -> Tuple[Tuple[str, int, int], ...]:
    """(name, offset, size) of each scratch region, in order, each starting
    ``SCRATCH_ALIGN``-aligned."""
    out, off = [], 0
    for name, size in sizes:
        out.append((name, off, size))
        off += -(-size // SCRATCH_ALIGN) * SCRATCH_ALIGN
    return tuple(out)


@functools.lru_cache(maxsize=64)
def grid_plan(cell: str, e: int, f: int, h: int, v: int, k: int,
              n_img: int, max_seq: int, grid: int) -> GridPlan:
    """The plan of one launch for ``n_img`` images on ``grid`` blocks;
    raises ValueError on what the kernel does not take."""
    if cell not in CELLS:
        raise ValueError(f"unknown cell {cell!r}; choose one of {CELLS}")
    check_kernel_widths(f, h, v)
    if not 1 <= k <= min(K_MAX, v):
        raise ValueError(f"k={k} outside [1, {min(K_MAX, v)}]")
    if e < 1 or n_img < 1 or max_seq < 0 or grid < 1:
        raise ValueError(f"e={e}, n_img={n_img}, max_seq={max_seq}, "
                         f"grid={grid}: each must be positive")
    rows = n_img * k
    if rows > MAX_ROWS:
        raise ValueError(f"{n_img} images x k={k} = {rows} rows: one launch "
                         f"takes at most {MAX_ROWS}")
    n_tiles = -(-v // V_TILE)
    if tail_floats(n_tiles, k, max_seq + 2) > NSLOT * SLOT_FLOATS:
        raise ValueError(f"V={v}, max_seq={max_seq}: the beam tail's "
                         "scratch does not fit the kernel's ring")
    stages = tuple(plan_stage(jobs, grid, rows)
                   for jobs in stage_jobs(cell, e, f, h, v))
    fact = cell == "factored"
    length = max_seq + 2
    floats = carve_regions([
        ("v", rows * 4 * f if fact else 0), ("hw", rows * 4 * h if fact else 0),
        ("s", rows * 4 * f if fact else 0), ("hn", 2 * rows * h),
        ("cn", 2 * rows * h), ("logits", rows * n_tiles * V_TILE),
        ("pm", rows * n_tiles), ("pse", rows * n_tiles),
        ("pv", rows * n_tiles * k), ("scores", rows), ("bscore", n_img)])
    ints = carve_regions([
        ("bar", 1), ("pi", rows * n_tiles * k), ("alive", rows),
        ("word", rows), ("prev", rows), ("seqs", rows * length),
        ("steps", 2 * n_img)])
    return GridPlan(cell, e, f, h, v, k, n_img, max_seq, grid, stages,
                    floats, ints)


def launch_chunks(batch: int, k: int) -> list:
    """(first image, images) of each launch of a ``batch``: at most
    ``MAX_ROWS // k`` images a launch."""
    per = MAX_ROWS // k
    return [(i, min(per, batch - i)) for i in range(0, batch, per)]


_PLAN_FIELDS = (
    "cell", "E", "F", "H", "V", "k", "n_img", "max_seq", "start", "end",
    "feed", "Vp", "n_tiles", "grid", "n_stages")
PLAN_ARRAYS = ("cw", "br", "n_slabs", "slab0")
_FLOAT_REGIONS = ("v", "hw", "s", "hn", "cn", "logits", "pm", "pse", "pv",
                  "scores", "bscore")
INT_REGIONS = ("pi", "alive", "word", "prev", "seqs", "steps", "bar")


class _CPlan(ctypes.Structure):
    """``csrc/beam.cu`` GridPlan, field by field (all 64-bit)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in _PLAN_FIELDS]
                + [(n, ctypes.c_longlong * MAX_STAGES) for n in PLAN_ARRAYS]
                + [("o_" + n, ctypes.c_longlong)
                   for n in _FLOAT_REGIONS + INT_REGIONS])


def plan_struct(cls, plan: GridPlan, vals: dict, regions) -> ctypes.Structure:
    """A kernel's plan struct (``cls``, a ctypes mirror): the scalar
    ``vals``, each stage's geometry and first slab, and the offset
    ``o_<name>`` of each scratch region in ``regions``."""
    c = cls()
    for name, val in vals.items():
        setattr(c, name, val)
    first = 0
    for i, st in enumerate(plan.stages):
        c.cw[i], c.br[i] = st.cw, st.br
        c.n_slabs[i], c.slab0[i] = len(st.slabs), first
        first += len(st.slabs)
    for name in regions:
        setattr(c, "o_" + name, plan.region(name)[0])
    return c


def _c_plan(plan: GridPlan, start: int, end: int, feed: bool) -> _CPlan:
    vals = dict(cell=CELLS.index(plan.cell), E=plan.e, F=plan.f, H=plan.h,
                V=plan.v, k=plan.k, n_img=plan.n_img, max_seq=plan.max_seq,
                start=start, end=end, feed=int(feed),
                Vp=plan.n_tiles * V_TILE, n_tiles=plan.n_tiles,
                grid=plan.grid, n_stages=len(plan.stages))
    return plan_struct(_CPlan, plan, vals, _FLOAT_REGIONS + INT_REGIONS)


_slab_tables: Dict[tuple, torch.Tensor] = {}
_max_grid: Dict[int, int] = {}


def slabs_on(plan: GridPlan, device: torch.device) -> torch.Tensor:
    """The plan's slab table on ``device``, cached by plan and device."""
    key = (plan, device.index)
    if key not in _slab_tables:
        if len(_slab_tables) >= 64:
            _slab_tables.clear()
        _slab_tables[key] = torch.from_numpy(plan.slab_table()).to(device)
    return _slab_tables[key]


def grid_blocks(lib: ctypes.CDLL, fn: str, cache: Dict[int, int],
                device: torch.device) -> int:
    """Blocks of one cooperative launch of a whole-search kernel on
    ``device``, by the library's occupancy query ``fn`` (cached per
    device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in cache:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            cuda_lib.check_rc(lib, getattr(lib, fn)(ctypes.byref(out)),
                              f"{fn}: occupancy")
        cache[idx] = out.value
    return cache[idx]


def max_grid(device: torch.device) -> int:
    """Blocks of one cooperative launch of the kernel on ``device``."""
    return grid_blocks(_library(), "icee_mega_beam_max_grid", _max_grid,
                       device)


def check_grid(grid: Optional[int], most: int) -> int:
    """The blocks of a launch: all the card holds, or ``grid`` of them."""
    blocks = most if grid is None else int(grid)
    if not 1 <= blocks <= most:
        raise ValueError(f"grid={grid} outside [1, {most}] (the blocks one "
                         "cooperative launch holds)")
    return blocks


def mega_beam_decode_steps(
        params: dict, features: Optional[torch.Tensor], style: int,
        batch: int, start_token: int = 1, end_token: int = 2, k: int = 5,
        max_seq_length: int = 40, cell: str = "factored",
        grid: Optional[int] = None
) -> Tuple[BeamResult, Optional[torch.Tensor]]:
    """:func:`mega_beam_decode`, plus a (batch, 2) int32 count per image:
    the steps it ran before its last beam ended, and the live row-steps
    (beams computed, summed over those steps), which size the work for a
    bound (None from the plain version on the CPU).  ``grid`` launches
    fewer blocks than the card holds (tests: the bits must not change)."""
    device = _head(params, cell).device
    if cell == "factored":
        e, f, hd, v, ns = check_decoder_params(params, device)
        if not 0 <= int(style) < ns:
            raise ValueError(f"style {style} outside [0, {ns})")
    else:
        e, hd, v = check_nic_params(params, device)
        f = hd
    if features is not None:
        cuda_lib.check_tensor("features", features, (batch, k, e),
                              torch.float32, device)
    check_beam_width("k", k, v, device, "K2 (csrc/beam.cu)")
    if device.type == "cpu":
        return mega_beam_decode_plain(params, features, int(style), batch,
                                      start_token, end_token, k,
                                      max_seq_length, cell), None
    if device.type != "cuda":
        raise ValueError(f"mega_beam_decode: unsupported device {device}")
    check_kernel_widths(f, hd, v)
    lib = _library()
    blocks = check_grid(grid, max_grid(device))
    p = cuda_lib.ptr
    if cell == "factored":
        s = int(style)
        weights = [p(params[n]) for n in ("V_w", "V_b")] + [
            p(params["S_w"][s]), p(params["S_b"][s])] + [
            p(params[n]) for n in ("U_w", "U_b", "W_w", "W_b", "C_w", "C_b")]
        emb, fn = params["B"], lib.icee_mega_beam_decode
    else:
        lc = params["cell"]
        weights = [p(lc[n]) for n in ("W_ih", "b_ih", "W_hh", "b_hh")] + [
            p(params["linear_w"]), p(params["linear_b"])]
        emb, fn = params["embed"], lib.icee_mega_beam_decode_lstm
    max_len = max_seq_length + 2
    i32 = dict(dtype=torch.int32, device=device)
    results = []
    for first, n_img in launch_chunks(batch, k):
        plan = grid_plan(cell, e, f, hd, v, k, n_img, max_seq_length,
                         blocks)
        feats = None
        if features is not None:
            feats = features[first:first + n_img]
        fs = torch.empty((plan.n_floats,), dtype=torch.float32,
                         device=device)
        ints = torch.zeros((plan.n_ints,), **i32)  # the barrier starts at 0
        tokens = torch.empty((n_img, max_len), **i32)
        length = torch.empty((n_img,), **i32)
        score = torch.empty((n_img,), dtype=torch.float32, device=device)
        cplan = _c_plan(plan, start_token, end_token, feats is not None)
        rc = fn(ctypes.byref(cplan), p(slabs_on(plan, device)),
                p(feats) if feats is not None else None, p(emb), *weights,
                p(fs), p(ints), p(tokens), p(length), p(score),
                cuda_lib.stream_ptr(device))
        cuda_lib.check_rc(lib, rc, f"mega_beam_decode (cell={cell})")
        if cell == "factored":
            mega_beam_decode.launches += 1
        else:
            mega_beam_decode.lstm_launches += 1
        off, size = plan.region("steps")
        results.append((tokens, length, score,
                        ints[off:off + size].view(n_img, 2).clone()))
    if len(results) == 1:
        tokens, length, score, steps = results[0]
    else:
        tokens, length, score, steps = (torch.cat(t) for t in zip(*results))
    return BeamResult(tokens=tokens, length=length, score=score), steps


mega_beam_decode.launches = 0       # kernel launches, cell="factored"
mega_beam_decode.lstm_launches = 0  # kernel launches, cell="lstm"


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = cuda_lib.library("beam", {
        "icee_mega_beam_decode": ([vp] * 20, i),
        "icee_mega_beam_decode_lstm": ([vp] * 16, i),
        "icee_mega_beam_max_grid": ([vp], i),
        "icee_mega_beam_consts": ([vp], None)})
    if getattr(lib, "geometry_checked", False):
        return lib
    consts = (ctypes.c_longlong * 7)()
    lib.icee_mega_beam_consts(consts)
    want = (THREADS, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS)
    if tuple(consts[1:]) != want:
        raise RuntimeError(f"csrc/beam.cu's geometry {tuple(consts[1:])} is "
                           f"not the wrapper's {want}")
    lib.geometry_checked = True
    return lib
