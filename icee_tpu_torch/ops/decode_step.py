"""K1: one FactoredLSTM decode step with an exact top-k over the vocabulary.

Port of ``icee_tpu/ops/pallas_decode.py::fused_decode_step_topk``.  The CUDA
kernel is ``csrc/decode_step.cu`` with two paths, chosen by the row count
alone and giving the same bits for a row:

* column-split (R <= ``SPLIT_ROWS`` = 8, one image's beam on the serial
  serving path; ``csrc/split_step.cuh``): five launches, each product's
  columns spread over the whole card, weights streamed by ``cp.async``;
  where its launches' shared memory does not hold R rows
  (:func:`split_k1_smem`: F above ~1,400 at R = 8), the row-tiled path;
* many-row (larger R, the batched shapes; ``csrc/step_kernels.cuh``):
  each product one register-tiled launch over all R rows (a block a tile
  of up to 128 rows x 128 columns, the tile shape :func:`gemm_pick`'s),
  so each weight tile is read once per tile of rows; then the gates, the
  logits (R, V) into device memory, the tile partials and the merge
  (:func:`step_plan` lists the launches).  It takes any width: no launch
  holds a whole row of h in shared memory.

A top-k above ``K_MAX`` = 8, up to V, takes either path with the wide
reduce (``csrc/wide_topk.cuh``): the head writes the logits to device
memory and a block a row takes logZ as the merge does and the top-k by a
radix select, the same bits as the k <= ``K_MAX`` merge would give; above
``K_WIDE`` = 256 the selection's survivors sit in device memory after the
logits (:func:`wide_cand_floats`) and are ranked from there.

:func:`decode_step_topk_plain` is the same function in plain PyTorch: the CPU
tests use it, and ``chip_smoke.py`` holds the kernel against it on the card.

:func:`decode_step_topk` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  Launch counts:
``decode_step_topk.launches`` (every call), ``.split_launches`` and
``.tiled_launches`` (each path; ``tiled`` is the many-row path), ``.wide_launches`` (a top-k above
``K_MAX``, either path).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from icee_tpu_torch.decode.beam import top_k
from icee_tpu_torch.ops import cuda_lib, widths
from icee_tpu_torch.ops.cells import factored_lstm_cell

V_TILE = 256   # csrc/decode_common.cuh VT
K_MAX = 8      # csrc/decode_common.cuh KMAX: the narrow paths' widest k
K_WIDE = 256   # csrc/wide_topk.cuh KWIDE: most survivors in shared memory
SPLIT_ROWS = 8  # csrc/split_step.cuh SPLIT_ROWS: most rows of the split path
# csrc/step_kernels.cuh: the many-row products' k tile, the tile shapes
# (BM, BN) in gemm_pick's order, the products a launch holds; a
# tile-partials block's warps, a gates block's threads
GEMM_BK = 8
GEMM_TILES = ((128, 128), (64, 128), (64, 64), (32, 64))
MAX_GEMM_JOBS = 3
PART_WARPS = 8
GATE_THREADS = 256
# csrc/split_step.cuh: a slab launch's ring and chunks
SPLIT_RING, SPLIT_CHUNK_ROWS, SPLIT_SLAB_F4 = 6, 128, 4

Step = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def decode_step_topk_plain(params: dict, x, h, c, style: int,
                           ktop: int = 5) -> Step:
    """Cell + head + log_softmax + top-k (ties to the lowest index) ->
    (logp (R, ktop) f32, idx (R, ktop) int32, h', c')."""
    h2, c2 = factored_lstm_cell(params, x, h, c, style)
    logits = h2 @ params["C_w"] + params["C_b"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    vals, idx = top_k(logp, ktop)
    return vals, idx.to(torch.int32), h2, c2


def check_decoder_params(params: dict, device: torch.device) -> Tuple[int, ...]:
    """Validate the decoder tensors the kernels read; -> (E, F, H, V, styles)."""
    e, f4 = params["V_w"].shape
    f, h = f4 // 4, params["W_w"].shape[0]
    v = params["C_w"].shape[1]
    ns = params["S_w"].shape[0]
    shapes = {"V_w": (e, 4 * f), "V_b": (4, f), "S_w": (ns, 4, f, f),
              "S_b": (ns, 4, f), "U_w": (4, f, h), "U_b": (4, h),
              "W_w": (h, 4 * h), "W_b": (4, h), "C_w": (h, v), "C_b": (v,),
              "B": (v, e)}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, params[name], shape, torch.float32, device)
    return e, f, h, v, ns


def check_beam_width(name: str, k: int, v: int) -> None:
    """A beam width or top-k ``name=k``: every route takes any ``1 <= k <=
    V`` (the card's k <= ``K_MAX`` paths pick from per-tile candidates, the
    wider ones select by a radix select over a block)."""
    if not 1 <= k <= v:
        raise ValueError(f"{name}={k} outside [1, {v}]")


def wide_cand_floats(rows: int, k: int) -> int:
    """Floats of the wide reduce's survivor scratch after a work buffer or
    the logits (``csrc/wide_topk.cuh`` ``wide_cand_pairs``, at the next
    8-byte boundary: ``split_step.cuh`` ``cand_after``): one 8-byte pair a
    row and survivor above ``K_WIDE``, else none."""
    return 1 + 2 * rows * k if k > K_WIDE else 0


def desc_keys(v: torch.Tensor) -> torch.Tensor:
    """``csrc/wide_topk.cuh``'s ``desc_key`` of float32 values, in an int64:
    larger values give smaller keys, -0 the key of +0."""
    bits = (v.float() + 0.0).contiguous().view(torch.int32).long() \
        & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, bits,
                       (bits | 0x80000000) ^ 0xFFFFFFFF)


def _radix_threshold(hists, n: int, k: int) -> int:
    """The radix select's threshold: ``hists(prefix, mask, shift)`` -> the
    256-bin histogram of the pairs matching the prefix on the bytes above
    ``shift``; passes a byte at a time from the top (an index byte above
    the largest index skipped, stopping once the chosen bin holds exactly
    the pairs still wanted) -> tau, exactly k pairs <= tau."""
    prefix = mask = 0
    rem = k
    for shift in range(56, -1, -8):
        if 0 < shift < 32 and (n - 1) >> shift == 0:
            mask |= 0xFF << shift
            continue
        hist = hists(prefix, mask, shift)
        incl = np.cumsum(hist)
        b = int(np.searchsorted(incl, rem))   # first bin reaching rem
        rem -= int(incl[b] - hist[b])
        prefix |= b << shift
        mask |= 0xFF << shift
        if hist[b] == rem:
            break
    return prefix | (~mask & 0xFFFFFFFFFFFFFFFF)


def _hist(p: np.ndarray, prefix: int, mask: int, shift: int) -> np.ndarray:
    sel = (p & np.uint64(mask)) == np.uint64(prefix)
    return np.bincount(((p[sel] >> np.uint64(shift)) & np.uint64(255))
                       .astype(np.int64), minlength=256)


def bitonic_sort_plain(pairs: np.ndarray) -> np.ndarray:
    """``csrc/wide_topk.cuh``'s ``emit_in_order`` sort, compare-exchange by
    compare-exchange: the uint64 pairs padded with 2^64 - 1 to a power of
    two, ``block_sort_pairs``' bitonic network (stage k, stride j: element
    lo = 2 i - (i & (j - 1)) against lo + j, ascending where lo & k is 0)
    -> the pairs ascending."""
    n = len(pairs)
    n2 = 1 << max(0, (n - 1).bit_length())
    v = np.full(n2, np.uint64(0xFFFFFFFFFFFFFFFF))
    v[:n] = pairs
    i = np.arange(n2 // 2)
    k = 2
    while k <= n2:
        j = k >> 1
        while j > 0:
            lo = 2 * i - (i & (j - 1))
            hi = lo + j
            x, y = v[lo], v[hi]
            swap = (x > y) == ((lo & k) == 0)
            v[lo] = np.where(swap, y, x)
            v[hi] = np.where(swap, x, y)
            j >>= 1
        k <<= 1
    return v[:n]


def block_select_plain(keys: torch.Tensor, k: int, order: str = "rank",
                       parts: int = 1) -> torch.Tensor:
    """``csrc/wide_topk.cuh``'s ``block_select``, step by step, on rows of
    32-bit keys (R, n) (int64, 0 <= key < 2^32) -> the indices (R, k)
    int64 of each row's k least pairs (key, index), in order: the radix
    select's histogram passes (:func:`_radix_threshold`), the survivors
    (every pair <= the threshold: exactly k), then their order by counting
    each one's rank (``order="rank"``, the kernels past the sort buffer) or
    by the bitonic sort (``"sort"``, :func:`bitonic_sort_plain`).
    ``parts`` > 1 models ``grid_beam.cuh``'s ``spread_select``: the n
    pairs cut into ``parts`` contiguous shares, each share's histogram
    counted alone and the histograms added in part order, the survivors
    gathered share by share."""
    rows, n = keys.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} outside [1, {n}]")
    pairs = ((keys.cpu().numpy().astype(np.uint64) << np.uint64(32))
             | np.arange(n, dtype=np.uint64))
    bounds = [n * q // parts for q in range(parts + 1)]
    out = np.empty((rows, k), dtype=np.int64)
    for r in range(rows):
        p = pairs[r]
        shares = [p[bounds[q]:bounds[q + 1]] for q in range(parts)]

        def hists(prefix, mask, shift):
            total = np.zeros(256, dtype=np.int64)
            for share in shares:
                total += _hist(share, prefix, mask, shift)
            return total

        tau = np.uint64(_radix_threshold(hists, n, k))
        cand = np.concatenate([share[share <= tau] for share in shares])
        assert cand.size == k, (cand.size, k)
        if order == "sort":
            ordered = bitonic_sort_plain(cand)
        else:
            rank = (cand[None, :] < cand[:, None]).sum(axis=1)
            ordered = np.empty(k, dtype=np.uint64)
            ordered[rank] = cand
        out[r] = (ordered & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return torch.from_numpy(out).to(keys.device)


def gemm_smem(cfg: int) -> int:
    """Bytes of shared memory of a many-row product block of tile shape
    ``cfg`` (``csrc/step_kernels.cuh`` ``gemm_smem``): two k tiles of its
    rows, k-major (GEMM_BK x BM + 4), and of the weight (GEMM_BK x BN)."""
    bm, bn = GEMM_TILES[cfg]
    return 4 * 2 * GEMM_BK * (bm + 4 + bn)


def gemm_blocks(cfg: int, m: int, jobs) -> int:
    """Blocks of a product launch of ``m`` rows and ``jobs`` (N, nseg)
    products at tile shape ``cfg``: row tiles x column tiles x segments,
    summed over the products."""
    bm, bn = GEMM_TILES[cfg]
    return sum(-(-m // bm) * nseg * -(-n // bn) for n, nseg in jobs)


def gemm_pick(m: int, jobs, sms: int = 132) -> int:
    """``gemm_pick``: the tile shape of a product launch, the least work
    on the busiest SM, ceil(blocks / sms) (BM BN + 8 (BM + BN)) (its
    blocks' outputs and the k tiles they copy), ties to the larger
    tile."""
    best, cost = 0, None
    for cfg, (bm, bn) in enumerate(GEMM_TILES):
        c = -(-gemm_blocks(cfg, m, jobs) // sms) * (bm * bn + 8 * (bm + bn))
        if cost is None or c < cost:
            best, cost = cfg, c
    return best


def step_plan(kind: str, rows: int, e: int, f: int, h: int, v: int,
              ktop: int, a: int = 0, p: int = 0, fs: int = 0, k: int = 1,
              sms: int = 132) -> list:
    """The many-row step's launches in order (``csrc/decode_step.cu``,
    ``csrc/att_decode_step.cu``), each ``(name, tile or None, blocks,
    threads, shared memory bytes)``, at the padded widths: ``kind`` "k1"
    (input width ``e``), "factored" or "lstm" (K6: ``rows`` = images x
    ``k``, input width e + fs, attention width ``a`` over ``p``
    positions)."""
    out = []

    def product(name, jobs):
        assert len(jobs) <= MAX_GEMM_JOBS
        cfg = gemm_pick(rows, jobs, sms)
        bm, bn = GEMM_TILES[cfg]
        out.append((name, (bm, bn), gemm_blocks(cfg, rows, jobs),
                    bm * bn // 64, gemm_smem(cfg)))

    if kind == "k1":
        product("pre", [(4 * f, 1), (4 * h, 1)])
    else:
        product("pre", [(a, 1), (fs, 1), (4 * h, 1)])
        group = min(k, K_MAX)
        groups = rows // k * -(-k // K_MAX)
        out.append(("scores", None, groups * -(-p // 8), 256,
                    4 * group * widths.quad(a)))
        out.append(("context", None, groups * -(-fs // 256), 64,
                    4 * group * widths.quad(p)))
    if kind != "lstm":
        if kind == "factored":
            product("v", [(4 * f, 1)])
        product("style", [(f, 4)])
        product("z", [(h, 4)])
    else:
        product("z", [(4 * h, 1)])
    out.append(("gates", None, -(-rows * h // GATE_THREADS), GATE_THREADS,
                0))
    product("logits", [(v, 1)])
    if ktop > K_MAX:
        out.append(("wide_reduce", None, rows, 512,
                    4 * (1024 + 16 * V_TILE + 2 * -(-v // V_TILE))))
    else:
        tiles = rows * -(-v // V_TILE)
        out.append(("tile_partials", None, -(-tiles // PART_WARPS),
                    PART_WARPS * 32, 4 * PART_WARPS * V_TILE))
        out.append(("merge", None, -(-rows // 8), 256, 0))
    return out


def step_work_floats(kind: str, rows: int, e: int, f: int, h: int, v: int,
                     ktop: int, a: int = 0, p: int = 0, fs: int = 0) -> int:
    """Floats of the many-row path's work buffer (``csrc/step_kernels.cuh``
    ``step_work``), each plane at a multiple of 4: (K6) att2, the gate
    pre-activation, the scores, x; the cell's h product; (factored) v, s;
    z; the logits; the partials (ktop <= K_MAX) or the wide reduce's
    survivors (above K_WIDE)."""
    def q(n):
        return (n + 3) & ~3

    tiles = -(-v // V_TILE)
    planes = []
    if kind != "k1":
        planes += [rows * a, rows * fs, rows * p, rows * widths.quad(e + fs)]
    planes.append(rows * 4 * h)
    if kind != "lstm":
        planes += [rows * 4 * f, rows * 4 * f]
    planes += [rows * 4 * h, rows * v]
    if ktop <= K_MAX:
        planes += [rows * tiles, rows * tiles, rows * tiles * ktop,
                   rows * tiles * ktop]
    elif ktop > K_WIDE:
        planes.append(2 * rows * ktop)
    return sum(q(n) for n in planes)


def split_slab_smem(k: int, gates: int, seg: bool, rows: int) -> int:
    """Bytes of shared memory of one column-split product launch
    (``csrc/split_step.cuh`` ``slab_smem_floats``): its ring, its input
    rows (a copy a gate where each gate reads its own segment) and, for
    the gates, the z exchange."""
    nch = -(-k // SPLIT_CHUNK_ROWS)
    kp = ((k + 31) & ~31) + 4
    floats = (min(nch, SPLIT_RING) * SPLIT_CHUNK_ROWS * 4 * SPLIT_SLAB_F4
              + (gates if seg else 1) * rows * kp
              + (4 * rows * SPLIT_SLAB_F4 if gates == 4 else 0))
    return 4 * floats


def split_cell_smem(factored: bool, rows: int, e: int, f: int, h: int,
                    fs: int = 0) -> int:
    """The largest of the split path's cell and pre launches
    (``split_cell_bytes``): the x and h products, the factored style and
    gates (four copies of s: R = 8 refuses F above ~1,400) or the LSTM
    gates over FS, the factored rows of V_w past E."""
    each = [split_slab_smem(e, 1, False, rows),
            split_slab_smem(h, 1, False, rows)]
    if factored:
        each += [split_slab_smem(f, 1, True, rows),
                 split_slab_smem(f, 4, True, rows)]
        if fs > 0:
            each.append(split_slab_smem(fs, 1, False, rows))
    else:
        each.append(split_slab_smem(fs, 4, False, rows))
    return max(each)


def split_k1_smem(rows: int, e: int, f: int, h: int) -> int:
    """Bytes of shared memory of K1's largest column-split launch at
    ``rows`` rows (``csrc/split_step.cuh`` ``split_k1_smem``)."""
    return split_cell_smem(True, rows, e, f, h)


FACTORED_WEIGHTS = ("V_w", "V_b", "S_w", "S_b", "U_w", "U_b", "W_w", "W_b",
                    "C_w", "C_b")   # the kernels' weight arguments, in order


def step_layout(params: dict, style: int) -> Tuple[widths.Widths, dict]:
    """K1's launch setup, also K2's with the factored cell: the widths
    (true, padded) and the weights the kernel reads (``FACTORED_WEIGHTS``,
    S the style's slice) laid out at the padded widths
    (``ops/widths.py``); the tensors themselves where no width grows."""
    e, f4 = params["V_w"].shape
    w = widths.widths(E=e, F=f4 // 4, H=params["W_w"].shape[0],
                      V=params["C_w"].shape[1])
    tree = {n: params[n] for n in FACTORED_WEIGHTS}
    tree["S_w"], tree["S_b"] = params["S_w"][style], params["S_b"][style]
    return w, widths.pad_tree(tree, w)


def _step_weights(params: dict, style: int, device: torch.device):
    """Validates the decoder's weights; -> (widths, kernel weights): on a
    CUDA device the kernel's weight arguments (addresses at the padded
    widths, and the padded tensors they point into), on the CPU None."""
    e, f, hd, v, ns = check_decoder_params(params, device)
    if not 0 <= style < ns:
        raise ValueError(f"style {style} outside [0, {ns})")
    if device.type == "cpu":
        return widths.widths(E=e, F=f, H=hd, V=v), None
    if device.type != "cuda":
        raise ValueError(f"decode_step_topk: unsupported device {device}")
    w, kern = step_layout(params, style)
    held = (tuple(cuda_lib.ptr(kern[n]) for n in FACTORED_WEIGHTS), kern)
    return widths.checked(w, held)


def decode_step_topk(params: dict, x: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, style: int, ktop: int = 5) -> Step:
    """-> (logp_top (R, ktop) f32, idx_top (R, ktop) int32, h', c').

    ``logp_top`` are the log-softmax values of each row's top-``ktop``
    vocabulary entries, descending (ties to the lowest id); ``idx_top`` their
    ids.  Float32 only.  Any F, H and V: on the card the kernel runs at
    widths rounded up to 4 (``ops/widths.py``), h and c padded in and cut
    back out.
    """
    device = x.device
    rows = x.shape[0]
    w, weights = cuda_lib.checked_weights(
        (params,), (int(style), device),
        lambda: _step_weights(params, int(style), device))
    e, hd, v = w["E"][0], w["H"][0], w["V"][0]
    cuda_lib.check_tensor("x", x, (rows, e), torch.float32, device)
    cuda_lib.check_tensor("h", h, (rows, hd), torch.float32, device)
    cuda_lib.check_tensor("c", c, (rows, hd), torch.float32, device)
    check_beam_width("ktop", ktop, v)
    if device.type == "cpu":
        return decode_step_topk_plain(params, x, h, c, int(style), ktop)

    lib = _library()
    fp, hp, vp = w["F"][1], w["H"][1], w["V"][1]
    f32 = dict(dtype=torch.float32, device=device)
    h_out = torch.empty((rows, hp), **f32)
    c_out = torch.empty((rows, hp), **f32)
    logp = torch.empty((rows, ktop), **f32)
    idx = torch.empty((rows, ktop), dtype=torch.int32, device=device)
    p = cuda_lib.ptr
    h_in, c_in = widths.pad_last(h, hp), widths.pad_last(c, hp)
    head = (p(x), p(h_in), p(c_in), *weights[0], p(h_out), p(c_out),
            p(logp), p(idx))
    split = (rows <= SPLIT_ROWS and split_k1_smem(rows, e, fp, hp)
             <= cuda_lib.SMEM_LIMIT)
    if split:
        work = torch.empty((lib.icee_decode_step_split_work(rows, fp, hp, vp)
                            + wide_cand_floats(rows, ktop),), **f32)
        rc = lib.icee_decode_step_topk_split(
            *head, p(work), rows, e, fp, hp, vp, ktop,
            cuda_lib.stream_ptr(device))
        decode_step_topk.split_launches += 1
    else:
        work = torch.empty((lib.icee_decode_step_work(rows, e, fp, hp, vp,
                                                      ktop),), **f32)
        rc = lib.icee_decode_step_topk(
            *head, p(work), rows, e, fp, hp, vp, ktop,
            cuda_lib.stream_ptr(device))
        decode_step_topk.tiled_launches += 1
    cuda_lib.check_rc(lib, rc, "decode_step_topk")
    decode_step_topk.launches += 1
    decode_step_topk.wide_launches += ktop > K_MAX
    return logp, idx, widths.cut_last(h_out, hd), widths.cut_last(c_out, hd)


decode_step_topk.launches = 0        # kernel calls, either path
decode_step_topk.split_launches = 0  # R <= SPLIT_ROWS (5 CUDA launches)
decode_step_topk.tiled_launches = 0  # the rest: the many-row path
decode_step_topk.wide_launches = 0   # ktop > K_MAX, either path


# (E_in, F, H) at which the library's plans and split-path shared memory
# are held to the mirrors when it loads: the flagship and training widths,
# each side of the split path's boundaries, ragged ones
MIRROR_SHAPES = tuple((e, f, h) for e in (16, 300, 301, 2348, 2349)
                      for f, h in ((32, 32), (512, 512), (544, 544),
                                   (548, 548), (772, 772), (776, 776),
                                   (1024, 1024), (1400, 1400),
                                   (1424, 1424), (2048, 2048),
                                   (2052, 2052), (512, 2048), (6000, 6000)))
MIRROR_ROWS = (9, 320, 1024)   # rows of the many-row plans held there


def mirror_gemm_pick(lib, m: int, jobs, sms: int) -> int:
    """The library's ``icee_step_gemm_pick`` for ``jobs`` (N, nseg)."""
    arr = ctypes.c_int * MAX_GEMM_JOBS
    ns = arr(*[n for n, _ in jobs])
    segs = arr(*[s for _, s in jobs])
    return lib.icee_step_gemm_pick(m, len(jobs), ns, segs, sms)


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.c_longlong
    lib = cuda_lib.library("decode_step", {
        "icee_decode_step_topk": ([vp] * 18 + [i] * 6 + [vp], i),
        "icee_decode_step_work": ([i] * 6, ll),
        "icee_decode_step_topk_split": ([vp] * 18 + [i] * 6 + [vp], i),
        "icee_decode_step_split_work": ([i] * 4, ll),
        "icee_step_gemm_pick": ([i, i, vp, vp, i], i),
        "icee_step_gemm_smem": ([i], ll),
        "icee_decode_step_split_smem": ([i] * 4, ll)})
    if getattr(lib, "mirrors_checked", False):
        return lib
    for cfg in range(len(GEMM_TILES)):
        if lib.icee_step_gemm_smem(cfg) != gemm_smem(cfg):
            raise RuntimeError(f"csrc/step_kernels.cuh's gemm_smem({cfg}) "
                               f"{lib.icee_step_gemm_smem(cfg)} is not the "
                               f"wrapper's {gemm_smem(cfg)}")
    for e, f, h in MIRROR_SHAPES:
        got = tuple(lib.icee_decode_step_split_smem(r, e, f, h)
                    for r in (1, 5, 8))
        want = tuple(split_k1_smem(r, e, f, h) for r in (1, 5, 8))
        for rows in MIRROR_ROWS:
            jobs = [(4 * f, 1), (4 * h, 1)]
            got += (mirror_gemm_pick(lib, rows, jobs, 132),
                    lib.icee_decode_step_work(rows, e, f, h, 8192, 5),
                    lib.icee_decode_step_work(rows, e, f, h, 8192, 300))
            want += (gemm_pick(rows, jobs, 132),
                     step_work_floats("k1", rows, e, f, h, 8192, 5),
                     step_work_floats("k1", rows, e, f, h, 8192, 300))
        if got != want:
            raise RuntimeError(f"csrc/decode_step.cu's plans and split "
                               f"shared memory {got} at (E, F, H) = "
                               f"{(e, f, h)} are not the wrapper's {want}")
    lib.mirrors_checked = True
    return lib
