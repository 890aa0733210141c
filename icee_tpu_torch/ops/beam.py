"""K2: the whole k-beam search in one launch, for the StyleNet FactoredLSTM
(``cell="factored"``) or the NIC decoder (``cell="lstm"``).

Port of ``icee_tpu/ops/pallas_beam.py::mega_beam_decode``.  The CUDA kernel
is ``csrc/beam.cu``: one block per group of images, persistent over every
step, with the cell, head, top-k, beam selection, parent gather,
best-completed tracking, next-token embedding and early exit inside; the
kernel is a template over the cell.  :func:`mega_beam_decode_plain` is the
same search in plain PyTorch (:func:`~icee_tpu_torch.decode.beam.
beam_search_batched` over the decoder's full-vocabulary step): the CPU tests
use it, and ``chip_smoke.py`` holds the kernel against it on the card.

:func:`mega_beam_decode` takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  Its launch counts
are ``mega_beam_decode.launches`` (factored) and
``mega_beam_decode.lstm_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.decode_step import (K_MAX, check_decoder_params,
                                            check_kernel_widths)

BEAM_ROWS = 8  # csrc/beam_common.cuh BEAM_ROWS: rows (images x k) per block
CELLS = ("factored", "lstm")


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
    for research semantics (``<start>``'s embedding at step 1).  As many
    images as fit ``BEAM_ROWS`` rows share one block.  ``cell="lstm"``
    decodes the NIC parameter tree and ignores ``style``.  Returns a
    :class:`BeamResult` with a leading batch dim, token-identical to
    :func:`mega_beam_decode_plain`.
    """
    return mega_beam_decode_steps(params, features, style, batch,
                                  start_token, end_token, k,
                                  max_seq_length, cell)[0]


def mega_beam_decode_steps(
        params: dict, features: Optional[torch.Tensor], style: int,
        batch: int, start_token: int = 1, end_token: int = 2, k: int = 5,
        max_seq_length: int = 40, cell: str = "factored"
) -> Tuple[BeamResult, Optional[torch.Tensor]]:
    """:func:`mega_beam_decode`, plus the (n_blocks,) int32 count of steps
    each block ran before its early exit (None from the plain version on
    the CPU), which sizes the work for a bound."""
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
    if not 1 <= k <= min(K_MAX, BEAM_ROWS, v):
        raise ValueError(f"k={k} outside [1, {min(K_MAX, BEAM_ROWS, v)}]")
    n_img = BEAM_ROWS // k
    if device.type == "cpu":
        return mega_beam_decode_plain(params, features, int(style), batch,
                                      start_token, end_token, k,
                                      max_seq_length, cell), None
    if device.type != "cuda":
        raise ValueError(f"mega_beam_decode: unsupported device {device}")
    check_kernel_widths(f, hd, v)

    lib = _library()
    smem = lib.icee_mega_beam_smem(e, f, hd, v, k, max_seq_length)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(f"mega_beam_decode needs {smem} bytes of shared "
                         f"memory per block, more than {cuda_lib.SMEM_LIMIT}")
    n_blocks = -(-batch // n_img)
    bp = n_blocks * n_img
    max_len = max_seq_length + 2
    feats = None
    if features is not None:
        feats = features
        if bp != batch:
            feats = torch.cat([feats, feats.new_zeros((bp - batch, k, e))])
    i32 = dict(dtype=torch.int32, device=device)
    tokens = torch.empty((bp, max_len), **i32)
    length = torch.empty((bp,), **i32)
    score = torch.empty((bp,), dtype=torch.float32, device=device)
    steps = torch.empty((n_blocks,), **i32)
    p = cuda_lib.ptr
    outs = (p(tokens), p(length), p(score), p(steps))
    sizes = (n_blocks, n_img, k)
    tail = (max_seq_length, start_token, end_token, int(features is not None),
            cuda_lib.stream_ptr(device))
    feats_p = p(feats) if feats is not None else None
    if cell == "factored":
        rc = lib.icee_mega_beam_decode(
            feats_p, p(params["B"]), p(params["V_w"]), p(params["V_b"]),
            p(params["S_w"][int(style)]), p(params["S_b"][int(style)]),
            p(params["U_w"]), p(params["U_b"]), p(params["W_w"]),
            p(params["W_b"]), p(params["C_w"]), p(params["C_b"]), *outs,
            *sizes, e, f, hd, v, *tail)
    else:
        lc = params["cell"]
        rc = lib.icee_mega_beam_decode_lstm(
            feats_p, p(params["embed"]), p(lc["W_ih"]), p(lc["b_ih"]),
            p(lc["W_hh"]), p(lc["b_hh"]), p(params["linear_w"]),
            p(params["linear_b"]), *outs, *sizes, e, hd, v, *tail)
    cuda_lib.check_rc(lib, rc, f"mega_beam_decode (cell={cell})")
    if cell == "factored":
        mega_beam_decode.launches += 1
    else:
        mega_beam_decode.lstm_launches += 1
    return BeamResult(tokens=tokens[:batch], length=length[:batch],
                      score=score[:batch]), steps


mega_beam_decode.launches = 0       # kernel launches, cell="factored"
mega_beam_decode.lstm_launches = 0  # kernel launches, cell="lstm"


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    return cuda_lib.library("beam", {
        "icee_mega_beam_decode": ([vp] * 16 + [i] * 11 + [vp], i),
        "icee_mega_beam_decode_lstm": ([vp] * 12 + [i] * 10 + [vp], i),
        "icee_mega_beam_smem": ([i] * 6, ctypes.c_longlong)})
