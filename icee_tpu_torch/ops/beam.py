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
Beam widths above ``K_MAX`` = 8, up to V, take the kernel's wide selection
(``csrc/wide_topk.cuh``): a row stage (a block a live row: logZ, the row's
top-k into device memory) and a wide tail (an image's k x k candidates
selected from L2, the sequences double-buffered in device memory); so do
k <= 8 where the narrow tail's partials outgrow the ring (V above ~80k).
Above ``K_WIDE`` = 256 the selections' survivors sit in device memory
(:func:`selection_kind`, ``SEL_SCAN``).  A launch holds at most
``MAX_ROWS`` rows, or one image of any k, so :func:`launch_chunks` splits
a batch into launches of ``max(1, MAX_ROWS // k)`` images (4 at k = 256);
an image of more than ``MAX_ROWS`` rows keeps each block's row lists in
device memory.

:func:`mega_beam_decode_plain` is the same search in plain PyTorch
(:func:`~icee_tpu_torch.decode.beam.beam_search_batched` over the decoder's
full-vocabulary step): the CPU tests use it, and ``chip_smoke.py`` holds the
kernel against it on the card.

:func:`mega_beam_decode` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Its launch counts
are ``mega_beam_decode.launches`` (factored) and
``mega_beam_decode.lstm_launches``, and of those with the wide selection
``.wide_launches`` and ``.lstm_wide_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.ops import cuda_lib, widths
from icee_tpu_torch.ops.decode_step import (K_MAX, K_WIDE, V_TILE,
                                            _step_weights, check_beam_width)

CELLS = ("factored", "lstm")
# csrc/grid_beam.cuh's geometry (checked against the library when it loads)
THREADS = 512        # a block's threads
KC = 64              # k rows of a ring chunk
KCP = KC + 4         # row stride of a chunk's input rows
NSLOT = 4            # ring chunks
SLOT_FLOATS = 7680   # floats of one chunk: weights, then input rows
MAX_ROWS = 1024      # rows (images x k) of one launch, unless one image
MAX_K = 46340        # widest beam: an image's k x k candidates by an int
MAX_BR = 64          # most rows of a unit
MAX_UNIT_ROWS = 128  # input rows of a unit, all sets (two a copying thread)
MAX_STAGES = 8
SCRATCH_ALIGN = 64   # floats: each scratch region starts 256-byte aligned
TOPK_FLOATS = 1024   # csrc/wide_topk.cuh: a block selection's scratch
RING_FLOATS = NSLOT * SLOT_FLOATS
TBM = 128            # csrc/grid_beam.cuh: live rows of a tile
TBN = 128            # columns of a tile (a gate tile: TBN // 4 of each gate)
# csrc/grid_beam.cuh Sel: the selection a launch runs
SEL_NARROW, SEL_WIDE, SEL_SCAN = 0, 1, 2


NIC_WEIGHTS = ("W_ih", "b_ih", "W_hh", "b_hh", "linear_w", "linear_b")


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


def nic_layout(params: dict) -> Tuple[widths.Widths, dict]:
    """K2's launch setup with the LSTM cell: the widths (true, padded; F is
    H) and the weights the kernel reads (``NIC_WEIGHTS``) laid out at the
    padded widths (``ops/widths.py``)."""
    v, e = params["embed"].shape
    h = params["cell"]["W_hh"].shape[0]
    w = widths.widths(E=e, F=h, H=h, V=v)
    tree = dict(params["cell"], linear_w=params["linear_w"],
                linear_b=params["linear_b"])
    return w, widths.pad_tree({n: tree[n] for n in NIC_WEIGHTS}, w)


def _nic_weights(params: dict, device: torch.device):
    """Validates the NIC decoder's weights; -> (widths, kernel weights) as
    ``decode_step._step_weights`` gives them for the factored cell."""
    e, h, v = check_nic_params(params, device)
    if device.type != "cuda":
        return widths.widths(E=e, F=h, H=h, V=v), None
    w, kern = nic_layout(params)
    held = (tuple(cuda_lib.ptr(kern[n]) for n in NIC_WEIGHTS), kern)
    return widths.checked(w, held)


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
    to :func:`mega_beam_decode_plain`.  Any F, H and V: on the card the
    kernel reads the weights at widths rounded up to 4 (``ops/widths.py``).
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
class TilePlan:
    """A stage's tile geometry (``csrc/grid_beam.cuh`` run_tiles): its tile
    slabs (job, segment, first column, width; a gate tile's width of each
    gate) and the least live rows at which a step takes them (0: never;
    then no slabs)."""
    slabs: Tuple[Tuple[int, int, int, int], ...] = ()
    min_rows: int = 0


@dataclass(frozen=True)
class GridPlan:
    """What one launch of ``csrc/beam.cu`` reads besides the tensors: the
    product stages (each stage's slabs, and its tiles), and the scratch
    layout (float and int regions, each ``(offset, size)`` in elements).
    The repr is the slab plan's alone (the tiles have their own:
    ``tiles``)."""
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
    tiles: Tuple[TilePlan, ...] = field(repr=False)

    @property
    def rows(self) -> int:
        return self.n_img * self.k

    @property
    def n_tiles(self) -> int:
        return -(-self.v // V_TILE)

    @property
    def selection(self) -> int:
        return selection_kind(self.n_tiles, self.k, self.max_seq + 2)

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
        """(slabs, 4) int32: every stage's slabs in turn, then every
        stage's tile slabs in turn."""
        return np.asarray([s for st in self.stages for s in st.slabs]
                          + [s for t in self.tiles for s in t.slabs],
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


# csrc/grid_beam.cuh TileCfg: k rows of a tile chunk by the input-row sets
# a chunk holds (4 where each gate reads its own rows)
TILE_KT = {1: 36, 4: 12}


TILE_SLOTS = 3      # the ring cut into tile slots (csrc/grid_beam.cuh TSLOTS)


def tile_chunk_floats(sets: int) -> int:
    """Floats of a tile chunk in a tile slot: the weights (KT, TBN), then
    each set's input rows (TBM, KT) and 8 floats of skew."""
    kt = TILE_KT[sets]
    return kt * TBN + sets * (TBM * kt + 8)


def tile_slabs(jobs: Tuple[Job, ...]) -> tuple:
    """A stage's tile slabs: up to ``TBN`` columns of a segment, a gate
    job's ``TBN`` / 4 of each gate."""
    slabs = []
    for ji, j in enumerate(jobs):
        if j.gates:
            w = TBN // 4
            slabs += [(ji, 0, c0, min(w, j.segw - c0))
                      for c0 in range(0, j.segw, w)]
        else:
            slabs += [(ji, seg, c0, min(TBN, j.segw - c0))
                      for seg in range(j.nseg)
                      for c0 in range(0, j.segw, TBN)]
    return tuple(slabs)


def tile_units(tiles: TilePlan, n: int) -> list:
    """The units a step of ``n`` live rows runs in tiles (``csrc/
    grid_beam.cuh`` tile_of), in unit order: (tile slab, first live row,
    live rows), the rows split evenly into tiles of at most ``TBM``, a
    slab's row tiles adjacent."""
    n_rt = -(-n // TBM)
    base, rem = divmod(n, n_rt)
    return [(slab, rt * base + min(rt, rem), base + (rt < rem))
            for slab in tiles.slabs for rt in range(n_rt)]


def stage_geo(tiles: TilePlan, n: int) -> bool:
    """Whether a step of ``n`` live rows runs the stage in tiles
    (``csrc/grid_beam.cuh`` stage_geo)."""
    return tiles.min_rows > 0 and n >= tiles.min_rows


# The cost model that picks a stage's geometry by its live rows: the
# card's time for a unit's 64 k rows, in us, on the H100 (NVIDIA H100
# 80GB HBM3, 700 W; fitted to scripts/search_turns.py's stage records,
# each geometry forced): a slab unit's, fixed and per row a thread runs
# (one or two); a tile unit's by its input sets, fixed and by the share of
# its warps that hold live rows.
SLAB_US = (0.70, 1.47)
TILE_US = {1: (4.65, 7.15), 4: (10.33, 10.64)}
TILE_LAUNCH_MIN = 3 * TBM  # a launch of fewer rows takes no tiles: their
                           # kernel's slab steps and tail cost more than the
                           # few tiled steps save


def stage_us(stage: StagePlan, slabs: tuple, sets: int, grid: int,
             rows: np.ndarray):
    """The cost model's time of a stage's 64 k rows at ``rows`` live rows
    (an array), (slabs, tiles): the units' rounds over ``grid`` blocks
    times a unit's time."""
    lanes = THREADS // (stage.cw // 4)
    n_rb = -(-rows // stage.br)
    per_thread = np.minimum(-(-(-(-rows // n_rb)) // lanes), 2)
    slab = (-(-(len(stage.slabs) * n_rb) // grid)
            * (SLAB_US[0] + SLAB_US[1] * per_thread))
    n_rt = -(-rows // TBM)
    warps = -(-(-(-rows // n_rt)) // 8) / (THREADS // 32)
    fixed, per = TILE_US[sets]
    tile = -(-(len(slabs) * n_rt) // grid) * (fixed + per * warps)
    return slab, tile


def tile_min_rows(stage: StagePlan, slabs: tuple, sets: int, grid: int,
                  rows: int) -> int:
    """The least live rows from which the cost model puts the tiles at or
    below the slabs at every count up to ``rows`` (the launch's), or 0 if
    none (always below ``TILE_LAUNCH_MIN`` rows)."""
    if rows < TILE_LAUNCH_MIN:
        return 0
    slab, tile = stage_us(stage, slabs, sets, grid, np.arange(1, rows + 1))
    worse = np.nonzero(tile > slab)[0]
    first = int(worse[-1]) + 2 if len(worse) else 1
    return first if first <= rows else 0


def plan_tiles(stage: StagePlan, grid: int, rows: int,
               two_chains: bool = False) -> TilePlan:
    """A stage's tile geometry for a launch of ``rows`` rows on ``grid``
    blocks: none where the slabs stay cheaper at every live-row count, nor
    for the LSTM cell's two chains (``two_chains``)."""
    if two_chains:
        return TilePlan()
    slabs = tile_slabs(stage.jobs)
    sets = max(j.sets for j in stage.jobs)
    least = tile_min_rows(stage, slabs, sets, grid, rows)
    return TilePlan(slabs, least) if least else TilePlan()


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


def narrow_tail_floats(n_tiles: int, k: int, length: int) -> int:
    """Floats of the narrow beam tail's scratch (``csrc/grid_beam.cuh``):
    K_MAX merging warps' copies, then one image's log-probs, ids,
    sequences and slot state."""
    return (K_MAX * merge_floats(n_tiles, k) + 2 * k * k + 2 * k * length
            + 6 * k + 4)


def tail_state_floats(k: int) -> int:
    """Floats of the wide tail's k-slot state."""
    return 5 * k + 4


def state_in_ring(k: int) -> bool:
    """Whether the wide tail's slot state sits in the ring (else, at
    ``SEL_SCAN``, in device memory: the ``tstate`` region)."""
    return TOPK_FLOATS + tail_state_floats(k) <= RING_FLOATS


def selection_kind(n_tiles: int, k: int, length: int) -> int:
    """The selection a search runs (``csrc/grid_beam.cuh`` ``sel_kind``):
    ``SEL_NARROW`` (the tile partials and the narrow tail) where k <=
    ``K_MAX`` and its scratch fits the ring, ``SEL_WIDE`` (the row stage
    and the wide tail) up to ``K_WIDE``, then ``SEL_SCAN`` (the same, the
    survivors in device memory)."""
    if k > K_WIDE:
        return SEL_SCAN
    if k > K_MAX or narrow_tail_floats(n_tiles, k, length) > RING_FLOATS:
        return SEL_WIDE
    return SEL_NARROW


def tail_floats(n_tiles: int, k: int, length: int) -> int:
    """Floats of the ring the selection takes: the narrow tail's scratch,
    or the larger of the wide row stage's (the selection's scratch, a tile
    a warp, the tiles' max and sum-exp) and the wide tail's (the
    selection's scratch and the slot state where it sits in the ring),
    whatever the length."""
    if selection_kind(n_tiles, k, length) == SEL_NARROW:
        return narrow_tail_floats(n_tiles, k, length)
    state = tail_state_floats(k) if state_in_ring(k) else 0
    return TOPK_FLOATS + max(THREADS // 32 * V_TILE + 2 * n_tiles, state)


def selection_regions(rows: int, n_tiles: int, k: int, length: int):
    """Sizes of the scratch regions the selection reads and writes: the
    tile partials pm, pse (rows, n_tiles) and pv, pi (rows, n_tiles, k) and
    the sequences (rows, length); with the wide selection pv, pi are each
    row's top-k (rows, k), pm and pse go unused, and the sequences take two
    planes."""
    if selection_kind(n_tiles, k, length) != SEL_NARROW:
        return dict(pm=0, pse=0, pv=rows * k, pi=rows * k,
                    seqs=2 * rows * length)
    return dict(pm=rows * n_tiles, pse=rows * n_tiles,
                pv=rows * n_tiles * k, pi=rows * n_tiles * k,
                seqs=rows * length)


def scan_regions(rows: int, k: int, grid: int):
    """The int regions only ``SEL_SCAN`` has (``csrc/grid_beam.cuh``
    GridArgs), each block's own part: cand, its selections' k survivors (8
    bytes each); tstate, the tail's slot state where it does not fit the
    ring; lists, its row lists (8 ints a row) where the launch holds more
    than ``MAX_ROWS`` rows."""
    return [("cand", 2 * grid * k),
            ("tstate", 0 if state_in_ring(k) else grid * tail_state_floats(k)),
            ("lists", 8 * grid * rows if rows > MAX_ROWS else 0)]


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
    """The plan of one launch for ``n_img`` images on ``grid`` blocks, at
    F, H and V rounded up to 4 (the padded layout the kernel reads,
    ``ops/widths.py``: the plan's ``f``, ``h``, ``v``); raises ValueError
    on what the kernel does not take."""
    if cell not in CELLS:
        raise ValueError(f"unknown cell {cell!r}; choose one of {CELLS}")
    check_plan_width("K2 (csrc/beam.cu)", k, v)
    f, h, v = widths.quad(f), widths.quad(h), widths.quad(v)
    if e < 1 or n_img < 1 or max_seq < 0 or grid < 1:
        raise ValueError(f"e={e}, n_img={n_img}, max_seq={max_seq}, "
                         f"grid={grid}: each must be positive")
    rows = n_img * k
    check_plan_rows(n_img, k)
    n_tiles = -(-v // V_TILE)
    check_ring(n_tiles, k, v, max_seq)
    stages = tuple(plan_stage(jobs, grid, rows)
                   for jobs in stage_jobs(cell, e, f, h, v))
    tiles = tuple(plan_tiles(st, grid, rows, two_chains=st.jobs[0].gates
                             and cell == "lstm") for st in stages)
    fact = cell == "factored"
    sel = selection_regions(rows, n_tiles, k, max_seq + 2)
    floats = carve_regions([
        ("v", rows * 4 * f if fact else 0), ("hw", rows * 4 * h if fact else 0),
        ("s", rows * 4 * f if fact else 0), ("hn", 2 * rows * h),
        ("cn", 2 * rows * h), ("logits", rows * n_tiles * V_TILE),
        ("pm", sel["pm"]), ("pse", sel["pse"]), ("pv", sel["pv"]),
        ("scores", rows), ("bscore", n_img)])
    ints = carve_regions([
        ("bar", 1), ("pi", sel["pi"]), ("alive", rows), ("word", rows),
        ("prev", rows), ("seqs", sel["seqs"]), ("steps", 2 * n_img)]
        + (scan_regions(rows, k, grid) if k > K_WIDE else []))
    return GridPlan(cell, e, f, h, v, k, n_img, max_seq, grid, stages,
                    floats, ints, tiles)


def check_plan_width(kernel: str, k: int, v: int) -> None:
    """The beam widths a whole-search kernel plans: 1 <= k <= V, and k x k
    candidates an image that an int indexes (k <= ``MAX_K``)."""
    if not 1 <= k <= v:
        raise ValueError(f"k={k} outside [1, {v}]")
    if k > MAX_K:
        raise ValueError(f"k={k}: the kernel {kernel} indexes an image's "
                         f"k x k candidates by an int (k <= {MAX_K})")


def check_plan_rows(n_img: int, k: int) -> None:
    """A launch holds at most ``MAX_ROWS`` rows, or one image of any k."""
    if n_img > 1 and n_img * k > MAX_ROWS:
        raise ValueError(f"{n_img} images x k={k} = {n_img * k} rows: one "
                         f"launch takes at most {MAX_ROWS}, or one image")


def check_ring(n_tiles: int, k: int, v: int, max_seq: int) -> None:
    """The selection's scratch fits the ring (the wide row stage's tiles'
    max and sum-exp: V up to ~3.2M)."""
    if tail_floats(n_tiles, k, max_seq + 2) > RING_FLOATS:
        raise ValueError(f"V={v}, max_seq={max_seq}: the beam tail's "
                         "scratch does not fit the kernel's ring")


def launch_chunks(batch: int, k: int) -> list:
    """(first image, images) of each launch of a ``batch``: at most
    ``MAX_ROWS // k`` images a launch, and at least one."""
    per = max(1, MAX_ROWS // k)
    return [(i, min(per, batch - i)) for i in range(0, batch, per)]


_PLAN_FIELDS = (
    "cell", "E", "F", "H", "V", "k", "n_img", "max_seq", "start", "end",
    "feed", "Vp", "n_tiles", "grid", "n_stages")
PLAN_ARRAYS = ("cw", "br", "n_slabs", "slab0")
TILE_ARRAYS = ("t_slabs", "t_slab0", "t_min")
_FLOAT_REGIONS = ("v", "hw", "s", "hn", "cn", "logits", "pm", "pse", "pv",
                  "scores", "bscore")
INT_REGIONS = ("pi", "alive", "word", "prev", "seqs", "steps", "bar",
               "cand", "lists", "tstate")


class _CPlan(ctypes.Structure):
    """``csrc/beam.cu`` GridPlan, field by field (all 64-bit)."""
    _fields_ = ([(n, ctypes.c_longlong) for n in _PLAN_FIELDS]
                + [(n, ctypes.c_longlong * MAX_STAGES)
                   for n in PLAN_ARRAYS + TILE_ARRAYS]
                + [("o_" + n, ctypes.c_longlong)
                   for n in _FLOAT_REGIONS + INT_REGIONS])


def plan_struct(cls, plan: GridPlan, vals: dict, regions) -> ctypes.Structure:
    """A kernel's plan struct (``cls``, a ctypes mirror): the scalar
    ``vals``, each stage's geometry and first slab (and, where the struct
    has them, its tile slabs, the first of them and its tile threshold),
    and the offset ``o_<name>`` of each scratch region in ``regions`` (0
    for one the plan has not: ``SEL_SCAN``'s)."""
    c = cls()
    for name, val in vals.items():
        setattr(c, name, val)
    first = 0
    for i, st in enumerate(plan.stages):
        c.cw[i], c.br[i] = st.cw, st.br
        c.n_slabs[i], c.slab0[i] = len(st.slabs), first
        first += len(st.slabs)
    if hasattr(c, "t_min"):
        for i, t in enumerate(plan.tiles):
            c.t_slabs[i], c.t_slab0[i] = len(t.slabs), first
            c.t_min[i] = t.min_rows
            first += len(t.slabs)
    held = {n for n, _, _ in plan.floats + plan.ints}
    for name in regions:
        if name in held:
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
        w, weights = cuda_lib.checked_weights(
            (params,), (int(style), device),
            lambda: _step_weights(params, int(style), device))
        emb = params["B"]
    else:
        w, weights = cuda_lib.checked_weights(
            (params, params["cell"]), ("lstm", device),
            lambda: _nic_weights(params, device))
        emb = params["embed"]
    e, f, hd, v = w["E"][0], w["F"][0], w["H"][0], w["V"][0]
    if features is not None:
        cuda_lib.check_tensor("features", features, (batch, k, e),
                              torch.float32, device)
    check_beam_width("k", k, v)
    if device.type == "cpu":
        return mega_beam_decode_plain(params, features, int(style), batch,
                                      start_token, end_token, k,
                                      max_seq_length, cell), None
    if device.type != "cuda":
        raise ValueError(f"mega_beam_decode: unsupported device {device}")
    lib = _library()
    blocks = check_grid(grid, max_grid(device))
    p = cuda_lib.ptr
    fn = (lib.icee_mega_beam_decode if cell == "factored"
          else lib.icee_mega_beam_decode_lstm)
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
                p(feats) if feats is not None else None, p(emb), *weights[0],
                p(fs), p(ints), p(tokens), p(length), p(score),
                cuda_lib.stream_ptr(device))
        cuda_lib.check_rc(lib, rc, f"mega_beam_decode (cell={cell})")
        prefix = "" if cell == "factored" else "lstm_"
        mega_beam_decode.__dict__[prefix + "launches"] += 1
        mega_beam_decode.__dict__[prefix + "wide_launches"] += (
            plan.selection != SEL_NARROW)
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
mega_beam_decode.wide_launches = 0       # of those, the wide selection
mega_beam_decode.lstm_wide_launches = 0


def search_split(lib: ctypes.CDLL, call, raw: bool = False) -> dict:
    """One ``call`` of a whole-search kernel (K2 or K7: ``lib`` is its
    library) with the search's profile marks on (``icee_grid_profile``,
    ``icee_grid_records``; the card's time of each part, summed over the
    call's launches and steps): the live-row scan and products, the row
    stage, the tail (ms), the steps, and each product stage's time and
    steps by geometry (``stages``: {stage: {"slab" | "tile": [steps,
    ms]}}; K7's scores and softmax stages as ``scores``, ``softmax``);
    with ``raw``, also each record as (stage, live rows, tiles taken,
    ms)."""
    prof, recs = lib.icee_grid_profile, lib.icee_grid_records
    words = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    cuda_lib.check_rc(lib, prof(1, None), "profile on")
    call()
    torch.cuda.synchronize()
    cuda_lib.check_rc(lib, prof(0, ctypes.addressof(words)), "profile off")
    cap, n = 4096, ctypes.c_int(0)
    out = (ctypes.c_ulonglong * (2 * cap))()
    cuda_lib.check_rc(lib, recs(ctypes.addressof(out), cap, ctypes.byref(n)),
                      "profile records")
    stages: Dict[str, Dict[str, list]] = {}
    names = {MAX_STAGES: "scores", MAX_STAGES + 1: "softmax"}
    records = []
    for r in range(min(n.value, cap)):
        key, ns = out[2 * r], out[2 * r + 1]
        sid = names.get((key >> 8) & 0xff, str((key >> 8) & 0xff))
        geo = "tile" if key & 1 else "slab"
        entry = stages.setdefault(sid, {}).setdefault(geo, [0, 0.0])
        entry[0] += 1
        entry[1] += ns / 1e6
        records.append((sid, int(key >> 32), int(key & 1), ns / 1e6))
    got = {"products_ms": words[0] / 1e6, "row_stage_ms": words[1] / 1e6,
           "tail_ms": words[2] / 1e6, "steps": int(words[4]),
           "stages": stages, "records": n.value}
    if raw:
        got["raw"] = records
    return got


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib = cuda_lib.library("beam", {
        "icee_mega_beam_decode": ([vp] * 20, i),
        "icee_mega_beam_decode_lstm": ([vp] * 16, i),
        "icee_mega_beam_max_grid": ([vp], i),
        "icee_mega_beam_consts": ([vp], None),
        "icee_grid_profile": ([i, vp], i),
        "icee_grid_records": ([vp, i, vp], i)})
    if getattr(lib, "geometry_checked", False):
        return lib
    consts = (ctypes.c_longlong * 10)()
    lib.icee_mega_beam_consts(consts)
    want = (THREADS, KC, KCP, NSLOT, SLOT_FLOATS, MAX_ROWS, K_WIDE,
            TOPK_FLOATS, MAX_K)
    if tuple(consts[1:]) != want:
        raise RuntimeError(f"csrc/beam.cu's geometry {tuple(consts[1:])} is "
                           f"not the wrapper's {want}")
    lib.geometry_checked = True
    return lib
