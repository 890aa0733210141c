"""K9: the SentiCap base mRNN's whole beam search for a batch of images.

Port of ``icee_tpu/ops/pallas_senticap_decode.py::mega_senticap_beam_decode``.
The CUDA kernel is ``csrc/senticap_beam.cu``: one C call runs every step
(cell, head, exact softmax, per-row top-k by nll with lowest-index ties,
per-image candidate selection, parent gather, next-word embedding) for all
images at once.  :func:`mega_senticap_beam_decode_plain` is the same search
in plain PyTorch (``senticap/beam.py::make_device_beam`` over the base
model's step): the CPU tests use it, and ``chip_smoke.py`` holds the kernel
against it on the card.

:func:`mega_senticap_beam_decode` takes the plain version only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.  Its launch
count is ``mega_senticap_beam_decode.launches``.  The TPU kernel's
``n_img_block``, ``v_tile``, ``n_streams`` and ``_profile`` are schedules of
the TPU and not part of the function: they are left out.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from icee_tpu_torch.ops import cuda_lib


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
    lib = _library()
    sel_smem = lib.icee_senticap_select_smem(beam_size, max_len)
    if max(sel_smem, 4 * vocab) > cuda_lib.SMEM_LIMIT:
        raise ValueError(f"mega_senticap_beam_decode needs "
                         f"{max(sel_smem, 4 * vocab)} bytes of shared memory "
                         f"per block, more than {cuda_lib.SMEM_LIMIT}")
    # the visual pseudo-word (mrnn.py:390-391): one product outside the
    # kernel, as the JAX wrapper computes it
    x0 = (v_feats @ params["wvm"] + params["bmv"]).contiguous()
    rows, seq_len = batch * beam_size, max_len + 1
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    scratch = dict(xh=torch.empty((rows, e + h), **f32),
                   c=torch.empty((rows, h), **f32),
                   z=torch.empty((rows, 4 * h), **f32),
                   hn=torch.empty((rows, h), **f32),
                   cn=torch.empty((rows, h), **f32),
                   logits=torch.empty((rows, vocab), **f32),
                   top_nll=torch.empty((rows, beam_size), **f32),
                   top_tok=torch.empty((rows, beam_size), **i32),
                   seqs=torch.empty((rows, seq_len), **i32),
                   lp=torch.empty((rows,), **f32))
    tokens = torch.empty((batch, seq_len), **i32)
    length = torch.empty((batch,), **i32)
    score = torch.empty((batch,), **f32)
    p = cuda_lib.ptr
    rc = lib.icee_senticap_beam(
        p(x0), p(params["wemb"]), p(params["w_lstm"]), p(params["w"]),
        p(params["b"]), *(p(scratch[k]) for k in scratch), p(tokens),
        p(length), p(score), batch, beam_size, e, h, vocab, max_len,
        stop_token, cuda_lib.stream_ptr(device))
    cuda_lib.check_rc(lib, rc, "mega_senticap_beam_decode")
    mega_senticap_beam_decode.launches += 1
    return score, tokens, length


mega_senticap_beam_decode.launches = 0  # wrapper calls on CUDA tensors


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    return cuda_lib.library("senticap_beam", {
        "icee_senticap_beam": ([vp] * 18 + [i] * 7 + [vp], i),
        "icee_senticap_select_smem": ([i, i], ctypes.c_longlong)})
