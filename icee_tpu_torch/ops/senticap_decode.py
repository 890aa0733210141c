"""K9: the SentiCap base mRNN's whole beam search for a batch of images.

Port of ``icee_tpu/ops/pallas_senticap_decode.py::mega_senticap_beam_decode``.
The CUDA kernel is ``csrc/senticap_beam.cu``: one C call lays the weights
out once as TF32 hi / lo planes, then runs every step (cell, head, exact
softmax, per-row top-k by nll with lowest-index ties, per-image candidate
selection, parent gather, next-word embedding) for all images at once.
:func:`mega_senticap_beam_decode_plain` is the same search in plain PyTorch
(``senticap/beam.py::make_device_beam`` over the base model's step): the
CPU tests use it, and ``chip_smoke.py`` holds the kernel against it on the
card.

:func:`mega_senticap_beam_decode` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.  Its launch
count is ``mega_senticap_beam_decode.launches``.  The TPU kernel's
``n_img_block``, ``v_tile``, ``n_streams`` and ``_profile`` are schedules of
the TPU and not part of the function: they are left out.

The pieces K9 and K10 (``ops/senticap_switched_decode.py``) share, each a
plain version beside its kernel (``csrc/senticap_beam.cuh``):

- :func:`launch_plan`: the cell product's k ranges, the padded depths,
  the planes' sizes and the row passes' shared memory of one search (its
  ctypes mirror ``_CPlan`` is ``SbPlan`` in the source, which re-derives
  every size and refuses a plan that differs);
- :func:`prepare_weights` / :func:`prepare_weights_plain`: a weight (K, N)
  laid out k-contiguous as TF32 hi / lo planes (Np, 2 Kp);
- :func:`planes_product` / :func:`planes_product_plain`: the 3xTF32
  product A W [+ bias] from those planes (``ops/att_scan.py``'s
  ``tf32x3_product`` arithmetic on wgmma);
- :func:`row_topk` / :func:`row_topk_plain`: the row selection, the beam
  least (nll, token) pairs of each row by a threshold (the K-th least of
  the threads' minima) and an exact order of the few survivors; where the
  row does not fit a block (beam above the threads, or V past the block's
  shared memory) by ``csrc/wide_topk.cuh``'s radix select from device
  memory (plain version ``decode_step.block_select_plain``).

A beam or vocabulary past one block's shared memory (the plan's
``topk_wide``, ``select_wide``) runs the row pass and the beam^2
candidates' selection from device memory, in a scratch of
``wide_floats`` floats: the same pairs in the same order, so a beam both
paths take gives the same bits on either.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.att_scan import tf32_split
from icee_tpu_torch.ops.decode_step import K_WIDE, block_select_plain

# csrc/senticap_beam.cuh's geometry
SP_BM, SP_BN, SP_BK = 128, 64, 32     # a product block's tile, k tile
SP_NP = 64                            # planes' rows: a multiple of this
SP_BLOCKS_PER_SM = 2                  # product blocks an SM holds
TOPK_THREADS = 256                    # threads of a row top-k block
MAX_BEAM = 46340                      # beam^2 candidates an int indexes
H100_SMS = 132


def _round_up(x: int, to: int) -> int:
    return (x + to - 1) // to * to


def planes_shape(k: int, n: int) -> Tuple[int, int]:
    """Shape of a weight (k, n)'s planes: (n rounded up to 64, 2 x k
    rounded up to 32)."""
    return _round_up(n, SP_NP), 2 * _round_up(k, SP_BK)


SP_UNIT_COST = 8   # a block's fixed cost in k tiles (ring fill, epilogue)


def product_splits(rows: int, n: int, k: int, batch: int,
                   sms: int = H100_SMS) -> int:
    """k ranges of a product without bias (1 or 2): 2 where the waves of
    half-depth units over the card's two-block slots cost less than the
    waves of whole tiles, a wave costing its units' k tiles plus
    ``SP_UNIT_COST`` (fitted to ``scripts/probe_sb_product.py``'s K9 and
    K10 cells: 1.14x faster split at 320 tiles, 0.96x at 640)."""
    tiles = math.ceil(rows / SP_BM) * math.ceil(n / SP_BN) * batch
    slots = SP_BLOCKS_PER_SM * sms
    depth = math.ceil(k / SP_BK)
    if depth < 2:
        return 1
    whole = math.ceil(tiles / slots) * (depth + SP_UNIT_COST)
    half = math.ceil(2 * tiles / slots) * (math.ceil(depth / 2)
                                           + SP_UNIT_COST)
    return 2 if half < whole else 1


def select_smem(beam: int, max_len: int, with_trace: bool) -> int:
    """Bytes of shared memory of one selection block."""
    k2, seq_len = beam * beam, max_len + 1
    return 4 * (2 * k2 + 3 * beam + beam * seq_len * (2 if with_trace else 1))


def topk_cap(vocab: int, beam: int) -> int:
    """Survivor slots of one row: at most beam x ceil(V / threads), even."""
    c = beam * math.ceil(vocab / TOPK_THREADS)
    return c + (c & 1)


def topk_smem(vocab: int, beam: int, paths: int) -> int:
    """Bytes of shared memory of one row top-k block: the warps' sorted
    minima, then the survivors (8 bytes each) and the row, or (two paths)
    the two rows, the second shared with the survivors."""
    cand = 8 * topk_cap(vocab, beam)
    if paths == 1:
        return 8 * TOPK_THREADS + cand + 4 * vocab
    return 8 * TOPK_THREADS + 4 * _round_up(vocab, 4) + max(4 * vocab, cand)


def topk_wide(vocab: int, beam: int, paths: int) -> bool:
    """Whether the row pass runs from device memory: a beam above its
    threads, or a block over the shared-memory limit."""
    return (beam > TOPK_THREADS
            or topk_smem(vocab, beam, paths) > cuda_lib.SMEM_LIMIT)


def select_wide(beam: int, max_len: int, with_trace: bool) -> bool:
    """Whether the selection runs from device memory."""
    return select_smem(beam, max_len, with_trace) > cuda_lib.SMEM_LIMIT


def topk_wide_floats(rows: int, beam: int) -> int:
    """Floats of the device-memory row pass's survivors: a row's beam
    8-byte pairs above ``K_WIDE``, else none."""
    return 2 * rows * beam if beam > K_WIDE else 0


def select_wide_floats(beam: int, max_len: int, with_trace: bool) -> int:
    """Floats of one image's part of the device-memory selection's
    scratch: the survivors' pairs (above ``K_WIDE``), the beam^2 totals and
    tokens, the old sequences (and traces), the new scores, parents and
    words; even."""
    f = ((2 * beam if beam > K_WIDE else 0) + 2 * beam * beam
         + beam * (max_len + 1) * (2 if with_trace else 1) + 3 * beam)
    return f + (f & 1)


def wide_floats(n_img: int, beam: int, vocab: int, max_len: int,
                paths: int) -> int:
    """Floats of a search's wide scratch: the row pass's survivors, then
    each image's selection part."""
    rows = n_img * beam
    return ((topk_wide_floats(rows, beam)
             if topk_wide(vocab, beam, paths) else 0)
            + (n_img * select_wide_floats(beam, max_len, paths == 2)
               if select_wide(beam, max_len, paths == 2) else 0))


class _CPlan(ctypes.Structure):
    """ctypes mirror of ``csrc/senticap_beam.cuh``'s ``SbPlan``."""
    _fields_ = [("cell_planes", ctypes.c_longlong),
                ("head_planes", ctypes.c_longlong),
                ("topk_smem", ctypes.c_longlong),
                ("select_smem", ctypes.c_longlong),
                ("cell_splits", ctypes.c_int),
                ("cell_kp", ctypes.c_int), ("head_kp", ctypes.c_int),
                ("topk_cap", ctypes.c_int), ("paths", ctypes.c_int),
                ("topk_wide", ctypes.c_int), ("select_wide", ctypes.c_int),
                ("wide_floats", ctypes.c_longlong)]


@dataclass(frozen=True)
class SbPlan:
    """The launch plan of one K9 (paths 1) or K10 (paths 2) search."""
    cell_planes: int   # floats of one path's prepared w_lstm
    head_planes: int   # floats of one path's prepared w
    topk_smem: int     # bytes of one row top-k block
    select_smem: int   # bytes of one selection block
    cell_splits: int   # k ranges of the cell product (1 or 2; the head
                       # adds a bias: one)
    cell_kp: int
    head_kp: int
    topk_cap: int
    paths: int
    topk_wide: int     # the row pass from device memory
    select_wide: int   # the selection from device memory
    wide_floats: int   # floats of the wide passes' scratch

    def planes_floats(self) -> int:
        """Floats of the planes scratch: every path's cell, then heads."""
        return self.paths * (self.cell_planes + self.head_planes)

    def c_struct(self) -> _CPlan:
        return _CPlan(*(getattr(self, f) for f, _ in _CPlan._fields_))


def launch_plan(what: str, n_img: int, beam: int, e: int, h: int,
                vocab: int, max_len: int, paths: int = 1,
                sms: int = H100_SMS) -> SbPlan:
    """The plan of a search on the card: a row pass and a selection from
    shared memory where they fit one block, else from device memory.
    Raises for a beam outside [1, V] or above ``MAX_BEAM`` (its beam^2
    candidates indexed by an int)."""
    if n_img < 1:
        raise ValueError(f"{what}: {n_img} images")
    if not 1 <= beam <= vocab:
        raise ValueError(f"beam_size {beam} outside [1, {vocab}]")
    if beam > MAX_BEAM:
        raise ValueError(f"{what}: beam_size {beam} > {MAX_BEAM}: the "
                         f"kernel indexes an image's beam^2 candidates by "
                         f"an int")
    if max_len < 0:
        raise ValueError(f"max_len {max_len} < 0")
    rows = n_img * beam
    cell_np, cell_2kp = planes_shape(e + h, 4 * h)
    head_np, head_2kp = planes_shape(h, vocab)
    plan = SbPlan(cell_planes=cell_np * cell_2kp,
                  head_planes=head_np * head_2kp,
                  topk_smem=topk_smem(vocab, beam, paths),
                  select_smem=select_smem(beam, max_len, paths == 2),
                  cell_splits=product_splits(rows, 4 * h, e + h, paths,
                                             sms),
                  cell_kp=cell_2kp // 2, head_kp=head_2kp // 2,
                  topk_cap=topk_cap(vocab, beam), paths=paths,
                  topk_wide=int(topk_wide(vocab, beam, paths)),
                  select_wide=int(select_wide(beam, max_len, paths == 2)),
                  wide_floats=wide_floats(n_img, beam, vocab, max_len,
                                          paths))
    return plan


def prepare_weights_plain(w: torch.Tensor) -> torch.Tensor:
    """A weight w (K, N) as the products read it: planes (Np, 2 Kp), row
    n = column n of w (zeros past K and N), each 32-deep k tile as its 32
    hi values, then its 32 lo values, with (hi, lo) = ``tf32_split``."""
    k, n = w.shape
    n_p, two_kp = planes_shape(k, n)
    kp = two_kp // 2
    padded = w.new_zeros((kp, n_p))
    padded[:k, :n] = w
    x = torch.stack(tf32_split(padded))           # (2, kp, Np)
    x = x.view(2, kp // SP_BK, SP_BK, n_p)        # k = 32 kt + kk
    return x.permute(3, 1, 0, 2).reshape(n_p, two_kp).contiguous()


def unpack_planes(planes: torch.Tensor, k: int, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """planes (Np, 2 Kp) -> (hi, lo), each (k, n): the inverse of
    :func:`prepare_weights_plain`'s layout."""
    n_p, two_kp = planes.shape
    x = planes.reshape(n_p, two_kp // (2 * SP_BK), 2, SP_BK)
    x = x.permute(2, 1, 3, 0).reshape(2, two_kp // 2, n_p)[:, :k, :n]
    return x[0], x[1]


def prepare_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`prepare_weights_plain` on the CPU; on the card the kernel
    K9 and K10 run once a call (``sb_prepare_kernel``), counted in
    ``prepare_weights.launches``."""
    if w.device.type == "cpu":
        return prepare_weights_plain(w)
    cuda_lib.check_tensor("w", w, tuple(w.shape), torch.float32, w.device)
    if w.dim() != 2:
        raise ValueError(f"w: shape {tuple(w.shape)}, expected (K, N)")
    planes = torch.empty(planes_shape(*w.shape), dtype=torch.float32,
                         device=w.device)
    lib = _library()
    rc = lib.icee_sb_prepare(cuda_lib.ptr(w), w.shape[0], w.shape[1],
                             cuda_lib.ptr(planes),
                             cuda_lib.stream_ptr(w.device))
    cuda_lib.check_rc(lib, rc, "prepare_weights")
    prepare_weights.launches += 1
    return planes


prepare_weights.launches = 0


def planes_product_plain(a: torch.Tensor, planes: torch.Tensor, n: int,
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The 3xTF32 product a W [+ bias] from W's planes, a (M, K) or (B, M,
    K) with planes (Np, 2 Kp) or (B, Np, 2 Kp) and bias (N,) or (B, N): a
    split as ``tf32_split``, lo_a hi_b + hi_a lo_b + hi_a hi_b summed in
    float64, cast to float32, then + bias (float32): ``ops/att_scan.py::
    tf32x3_product_plain``'s arithmetic."""
    k = a.shape[-1]
    if a.dim() == 3:
        return torch.stack([planes_product_plain(
            a[z], planes[z], n, None if bias is None else bias[z])
            for z in range(a.shape[0])])
    bh, bl = (x.double() for x in unpack_planes(planes, k, n))
    ah, al = (x.double() for x in tf32_split(a))
    out = ((al @ bh + ah @ bl) + ah @ bh).float()
    return out if bias is None else out + bias


def planes_product(a: torch.Tensor, planes: torch.Tensor, n: int,
                   bias: Optional[torch.Tensor] = None,
                   splits: int = 1) -> torch.Tensor:
    """a W [+ bias] from W's planes (shapes as
    :func:`planes_product_plain`): the plain version on the CPU; on the
    card the product K9 and K10 launch every step (``sb_product_kernel``),
    counted in ``planes_product.launches``; with ``splits`` 2 (no bias)
    its two k ranges' partial sums added in range order, as the search's
    gates kernel adds them."""
    if a.device.type == "cpu":
        return planes_product_plain(a, planes, n, bias)
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2:]
    shape = planes_shape(k, n)
    lead = (batch,) if a.dim() == 3 else ()
    device = a.device
    cuda_lib.check_tensor("a", a, lead + (m, k), torch.float32, device)
    cuda_lib.check_tensor("planes", planes, lead + shape, torch.float32,
                          device)
    if bias is not None:
        cuda_lib.check_tensor("bias", bias, lead + (n,), torch.float32,
                              device)
    if batch > 2:
        raise ValueError(f"planes_product: batch {batch} > 2 paths")
    if splits not in (1, 2) or (splits == 2 and bias is not None):
        raise ValueError(f"planes_product: splits {splits} (1, or 2 "
                         f"without bias)")
    out = torch.empty((splits,) + lead + (m, n), dtype=torch.float32,
                      device=device)
    p, null = cuda_lib.ptr, ctypes.c_void_p(0)
    biases = [null, null] if bias is None else [
        p(bias[z] if bias.dim() == 2 else bias) for z in range(batch)] * 2
    lib = _library()
    rc = lib.icee_sb_product(p(a), k, m * k, p(planes), shape[0] * shape[1],
                             shape[1] // 2, biases[0], biases[1], p(out), n,
                             m * n, batch * m * n, m, n, k, batch, splits,
                             cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "planes_product")
    planes_product.launches += 1
    return out[0] if splits == 1 else out[0] + out[1]


planes_product.launches = 0


def _keys(nll: torch.Tensor) -> torch.Tensor:
    """Each nll of rows (R, V) as the kernel's 32-bit key (``sb_key``: the
    float's bits made order-preserving, -0 as +0), in an int64."""
    bits = (nll + 0.0).contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                       bits | 0x80000000)


def _pairs(nll: torch.Tensor) -> torch.Tensor:
    """Each (nll, token) of rows nll (R, V) as one int64 key in the order
    (nll, token): the float's bits made order-preserving (-0 as +0), less
    2^63 so that signed order is the unsigned order of the kernel's key,
    the token below."""
    key = _keys(nll)
    tok = torch.arange(nll.shape[-1], dtype=torch.int64, device=nll.device)
    return ((key - 0x80000000) << 32) | tok


def row_topk_plain(nll: torch.Tensor, k: int,
                   threads: int = TOPK_THREADS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The row selection of ``csrc/senticap_beam.cuh::sb_select_row``, step
    by step, on rows nll (R, V) -> (the k least nll of each row in order,
    -0 as +0, their tokens), ties to the lowest token: each of ``threads``
    threads' least pair over its tokens c = thread + i threads; tau, the
    k-th least of those minima; the survivors, every pair <= tau; their
    order.  At the kernel's threads where the row does not fit a block
    (:func:`topk_wide`), the device-memory path's radix select instead
    (``decode_step.block_select_plain``)."""
    rows, vocab = nll.shape
    if threads == TOPK_THREADS and 1 <= k <= vocab and topk_wide(vocab, k,
                                                                 1):
        tok = block_select_plain(_keys(nll), k)
        return torch.gather(nll + 0.0, 1, tok), tok.to(torch.int32)
    if not 1 <= k <= min(vocab, threads):
        raise ValueError(f"k {k} outside [1, min(V, threads)]")
    pairs = _pairs(nll)
    cols = math.ceil(vocab / threads) * threads
    sentinel = (0x7FFFFFFF << 32) | (vocab + torch.arange(cols))
    grid = sentinel.expand(rows, cols).clone()
    grid[:, :vocab] = pairs
    # thread t's tokens are grid[:, t::threads]
    minima = grid.view(rows, cols // threads, threads).min(dim=1).values
    tau = minima.sort(dim=1).values[:, k - 1:k]
    out_nll = torch.empty((rows, k), dtype=nll.dtype)
    out_tok = torch.empty((rows, k), dtype=torch.int32)
    for r in range(rows):
        alive = pairs[r][pairs[r] <= tau[r]]
        cap = k * math.ceil(vocab / threads)
        assert k <= alive.numel() <= cap, (alive.numel(), cap)
        order = alive.sort().values[:k]
        tok = order & 0xFFFFFFFF
        out_tok[r] = tok.to(torch.int32)
        out_nll[r] = (nll[r] + 0.0)[tok]
    return out_nll, out_tok


def row_topk(nll: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k least (nll, token) pairs of each row of nll (R, V), in order,
    ties to the lowest token: :func:`row_topk_plain` on the CPU; on the
    card the selection K9 and K10 run, alone (``sb_row_select_kernel``),
    counted in ``row_topk.launches`` (from device memory where the row
    does not fit a block: :func:`topk_wide`)."""
    if nll.device.type == "cpu":
        return row_topk_plain(nll, k)
    rows, vocab = nll.shape
    cuda_lib.check_tensor("nll", nll, (rows, vocab), torch.float32,
                          nll.device)
    if not 1 <= k <= vocab:
        raise ValueError(f"k {k} outside [1, {vocab}]")
    out_nll = torch.empty((rows, k), dtype=torch.float32, device=nll.device)
    out_tok = torch.empty((rows, k), dtype=torch.int32, device=nll.device)
    cand = torch.empty((max(1, topk_wide_floats(rows, k)),),
                       dtype=torch.float32, device=nll.device)
    lib = _library()
    p = cuda_lib.ptr
    rc = lib.icee_sb_row_select(p(nll), rows, vocab, k, p(out_nll),
                                p(out_tok), p(cand),
                                cuda_lib.stream_ptr(nll.device))
    cuda_lib.check_rc(lib, rc, "row_topk")
    row_topk.launches += 1
    return out_nll, out_tok


row_topk.launches = 0


def check_params(params: dict, v_feats: torch.Tensor, batch: int,
                 conf: Optional[dict] = None) -> Tuple[int, int, int]:
    """Validate the base model's tensors and the features; -> (E, H, V).
    Raises for the BATCH_NORM and SOFTMAX_OUT=False regimes, which the
    kernel does not compute."""
    if "gamma_h" in params or (conf or {}).get("BATCH_NORM", False):
        raise ValueError("mega_senticap_beam_decode: BATCH_NORM models run "
                         "the device beam (senticap/beam.py)")
    if not (conf or {}).get("SOFTMAX_OUT", True):
        raise ValueError("mega_senticap_beam_decode: the kernel's head is "
                         "the softmax (SOFTMAX_OUT=True)")
    vocab, e = params["wemb"].shape
    h = params["w"].shape[0]
    device = params["w"].device
    vis = params["wvm"].shape[0]
    shapes = {"wemb": (vocab, e), "w_lstm": (e + h, 4 * h), "w": (h, vocab),
              "b": (vocab,), "wvm": (vis, e), "bmv": (e,)}
    for name, shape in shapes.items():
        cuda_lib.check_tensor(name, params[name], shape, torch.float32,
                              device)
    cuda_lib.check_tensor("v_feats", v_feats, (batch, vis), torch.float32,
                          device)
    return e, h, vocab


def mega_senticap_beam_decode_plain(params: dict, v_feats: torch.Tensor,
                                    batch: int, beam_size: int = 20,
                                    max_len: int = 20, stop_token: int = 0
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The search K9 runs, as ``make_device_beam`` over the base model's
    step -> (score (B,), tokens (B, max_len + 1), length (B,))."""
    from icee_tpu_torch.senticap.beam import make_device_beam
    from icee_tpu_torch.senticap.model import beam_step

    # the kernel's regime: softmax head, no BATCH_NORM; the clip bound
    # acts on gradients only
    step = beam_step(params, {"GRAD_CLIP_SIZE": 5.0, "BATCH_NORM": False,
                              "SOFTMAX_OUT": True})
    run = make_device_beam(step, params["w"].shape[0], beam_size, max_len,
                           stop_token)
    score, tokens, length = run(v_feats[:batch])
    return score, tokens.to(torch.int32), length.to(torch.int32)


def mega_senticap_beam_decode(params: dict, v_feats: torch.Tensor,
                              batch: int, beam_size: int = 20,
                              max_len: int = 20, stop_token: int = 0,
                              conf: Optional[dict] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Whole-search SentiCap beam decode for ``batch`` images (base mRNN,
    softmax head, no BATCH_NORM: the COCO test regime).  ``conf``, where
    given, is checked for those regimes.  Returns ``(score (B,), tokens
    (B, max_len + 1) int32, length (B,) int32)`` matching
    :func:`mega_senticap_beam_decode_plain`."""
    e, h, vocab = check_params(params, v_feats, batch, conf)
    if not 1 <= beam_size <= vocab:
        raise ValueError(f"beam_size {beam_size} outside [1, {vocab}]")
    if max_len < 0:
        raise ValueError(f"max_len {max_len} < 0")
    device = params["w"].device
    if device.type == "cpu":
        return mega_senticap_beam_decode_plain(params, v_feats, batch,
                                               beam_size, max_len, stop_token)
    if device.type != "cuda":
        raise ValueError(f"mega_senticap_beam_decode: unsupported device "
                         f"{device}")
    plan = launch_plan("mega_senticap_beam_decode", batch, beam_size, e, h,
                       vocab, max_len, 1, sm_count(device))
    lib = _library()
    # the visual pseudo-word (mrnn.py:390-391): one product outside the
    # kernel, as the JAX wrapper computes it
    x0 = (v_feats @ params["wvm"] + params["bmv"]).contiguous()
    rows, seq_len = batch * beam_size, max_len + 1
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    scratch = dict(planes=torch.empty((plan.planes_floats(),), **f32),
                   xh=torch.empty((rows, e + h), **f32),
                   c=torch.empty((rows, h), **f32),
                   z=torch.empty((plan.cell_splits, rows, 4 * h), **f32),
                   hn=torch.empty((rows, h), **f32),
                   cn=torch.empty((rows, h), **f32),
                   logits=torch.empty((rows, vocab), **f32),
                   top_nll=torch.empty((rows, beam_size), **f32),
                   top_tok=torch.empty((rows, beam_size), **i32),
                   seqs=torch.empty((rows, seq_len), **i32),
                   lp=torch.empty((rows,), **f32),
                   wide=torch.empty((max(1, plan.wide_floats),), **f32))
    tokens = torch.empty((batch, seq_len), **i32)
    length = torch.empty((batch,), **i32)
    score = torch.empty((batch,), **f32)
    p = cuda_lib.ptr
    c_plan = plan.c_struct()
    rc = lib.icee_senticap_beam(
        ctypes.byref(c_plan), p(x0), p(params["wemb"]), p(params["w_lstm"]),
        p(params["w"]), p(params["b"]), *(p(scratch[k]) for k in scratch),
        p(tokens),
        p(length), p(score), batch, beam_size, e, h, vocab, max_len,
        stop_token, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "mega_senticap_beam_decode")
    mega_senticap_beam_decode.launches += 1
    return score, tokens, length


mega_senticap_beam_decode.launches = 0  # wrapper calls on CUDA tensors


_sms = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (the products' slots are two an SM)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def _library() -> ctypes.CDLL:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return cuda_lib.library("senticap_beam", {
        "icee_senticap_beam": ([vp] * 21 + [i] * 7 + [vp], i),
        "icee_sb_prepare": ([vp, i, i, vp, vp], i),
        "icee_sb_product": ([vp, ll, ll, vp, ll, i, vp, vp, vp, ll, ll, ll]
                            + [i] * 5 + [vp], i),
        "icee_sb_row_select": ([vp, i, i, i, vp, vp, vp, vp], i)})
