"""K1: one FactoredLSTM decode step with an exact top-k over the vocabulary.

Port of ``icee_tpu/ops/pallas_decode.py::fused_decode_step_topk``.  The CUDA
kernel is ``csrc/decode_step.cu`` with two paths, chosen by the row count
alone and giving the same bits for a row:

* column-split (R <= ``SPLIT_ROWS`` = 8, one image's beam on the serial
  serving path; ``csrc/split_step.cuh``): five launches, each product's
  columns spread over the whole card, weights streamed by ``cp.async``;
* row-tiled (larger R, the batched shapes; ``csrc/step_kernels.cuh``):
  three launches, cell, per-tile head partials, merge; the (R, V) logits
  never reach device memory.

:func:`decode_step_topk_plain` is the same function in plain PyTorch: the CPU
tests use it, and ``chip_smoke.py`` holds the kernel against it on the card.

:func:`decode_step_topk` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.  Launch counts:
``decode_step_topk.launches`` (every call), ``.split_launches`` and
``.tiled_launches`` (each path).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from icee_tpu_torch.decode.beam import top_k
from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.cells import factored_lstm_cell

V_TILE = 256   # csrc/decode_common.cuh VT
K_MAX = 8      # csrc/decode_common.cuh KMAX
SPLIT_ROWS = 8  # csrc/split_step.cuh SPLIT_ROWS: most rows of the split path

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


def check_kernel_widths(*dims: int) -> None:
    """The kernels read weights (and features) as float4 column quads: the
    widths (F, H, V; A and FS for the attention kernels) must be multiples
    of 4."""
    if any(d % 4 for d in dims):
        raise ValueError(f"widths {dims}: the CUDA kernels take multiples "
                         "of 4 only")


def check_beam_width(name: str, k: int, v: int, device: torch.device,
                     kernel: str) -> None:
    """A beam width or top-k ``name=k``: the plain route takes any ``1 <= k
    <= V``; the CUDA kernels hold a row's top-k in registers and take at
    most ``K_MAX``."""
    if not 1 <= k <= v:
        raise ValueError(f"{name}={k} outside [1, {v}]")
    if device.type == "cuda" and k > K_MAX:
        raise ValueError(f"{name}={k}: the CUDA kernel {kernel} takes at "
                         f"most K_MAX = {K_MAX}")


def _step_weights(params: dict, style: int, device: torch.device):
    """Validates the decoder's weights; -> (E, F, H, V, addresses): on a
    CUDA device the kernel's weight arguments (the style's S slice), on the
    CPU None."""
    e, f, hd, v, ns = check_decoder_params(params, device)
    if not 0 <= style < ns:
        raise ValueError(f"style {style} outside [0, {ns})")
    if device.type == "cpu":
        return e, f, hd, v, None
    if device.type != "cuda":
        raise ValueError(f"decode_step_topk: unsupported device {device}")
    check_kernel_widths(f, hd, v)
    p = cuda_lib.ptr
    return e, f, hd, v, (p(params["V_w"]), p(params["V_b"]),
                         p(params["S_w"][style]), p(params["S_b"][style]),
                         p(params["U_w"]), p(params["U_b"]), p(params["W_w"]),
                         p(params["W_b"]), p(params["C_w"]), p(params["C_b"]))


def decode_step_topk(params: dict, x: torch.Tensor, h: torch.Tensor,
                     c: torch.Tensor, style: int, ktop: int = 5) -> Step:
    """-> (logp_top (R, ktop) f32, idx_top (R, ktop) int32, h', c').

    ``logp_top`` are the log-softmax values of each row's top-``ktop``
    vocabulary entries, descending (ties to the lowest id); ``idx_top`` their
    ids.  Float32 only.
    """
    device = x.device
    rows = x.shape[0]
    e, f, hd, v, weights = cuda_lib.checked_weights(
        (params,), (int(style), device),
        lambda: _step_weights(params, int(style), device))
    cuda_lib.check_tensor("x", x, (rows, e), torch.float32, device)
    cuda_lib.check_tensor("h", h, (rows, hd), torch.float32, device)
    cuda_lib.check_tensor("c", c, (rows, hd), torch.float32, device)
    check_beam_width("ktop", ktop, v, device, "K1 (csrc/decode_step.cu)")
    if device.type == "cpu":
        return decode_step_topk_plain(params, x, h, c, int(style), ktop)

    lib = _library()
    f32 = dict(dtype=torch.float32, device=device)
    h_out = torch.empty((rows, hd), **f32)
    c_out = torch.empty((rows, hd), **f32)
    logp = torch.empty((rows, ktop), **f32)
    idx = torch.empty((rows, ktop), dtype=torch.int32, device=device)
    p = cuda_lib.ptr
    head = (p(x), p(h), p(c), *weights, p(h_out), p(c_out), p(logp), p(idx))
    if rows <= SPLIT_ROWS:
        work = torch.empty((lib.icee_decode_step_split_work(rows, f, hd, v),),
                           **f32)
        rc = lib.icee_decode_step_topk_split(
            *head, p(work), rows, e, f, hd, v, ktop,
            cuda_lib.stream_ptr(device))
        decode_step_topk.split_launches += 1
    else:
        n_tiles = -(-v // V_TILE)
        pm = torch.empty((rows, n_tiles), **f32)
        pse = torch.empty((rows, n_tiles), **f32)
        pv = torch.empty((rows, n_tiles, ktop), **f32)
        pi = torch.empty((rows, n_tiles, ktop), dtype=torch.int32,
                         device=device)
        rc = lib.icee_decode_step_topk(
            *head, p(pm), p(pse), p(pv), p(pi), rows, e, f, hd, v, ktop,
            cuda_lib.stream_ptr(device))
        decode_step_topk.tiled_launches += 1
    cuda_lib.check_rc(lib, rc, "decode_step_topk")
    decode_step_topk.launches += 1
    return logp, idx, h_out, c_out


decode_step_topk.launches = 0        # kernel calls, either path
decode_step_topk.split_launches = 0  # R <= SPLIT_ROWS (5 CUDA launches)
decode_step_topk.tiled_launches = 0  # larger R (3 CUDA launches)


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    return cuda_lib.library("decode_step", {
        "icee_decode_step_topk": ([vp] * 21 + [i] * 6 + [vp], i),
        "icee_decode_step_topk_split": ([vp] * 18 + [i] * 6 + [vp], i),
        "icee_decode_step_split_work": ([i] * 4, ctypes.c_longlong)})
