"""K7: the whole attention beam search in one launch, for StyleNet+Att
(``kind="factored"``) and NIC+Att (``kind="lstm"``).

Port of ``icee_tpu/ops/pallas_att_decode.py::mega_att_beam_decode``, both
of its calls (the resident and the P-streamed one, which compute the same
function).  The CUDA kernel is ``csrc/att_beam.cu``: one block per image,
persistent over every step, with h0/c0 from the mean feature, the
re-attention, the cell, head, top-k, beam selection, parent gather,
best-completed tracking, next-token embedding and early exit inside.  The
TPU scheduling knobs (``n_img_block``, ``n_streams``, ``topk_fold``,
``p_stream``, ``p_tile``, ``_profile``) have no counterpart.
:func:`mega_att_beam_decode_plain` is the same search in plain PyTorch
(``beam_search_batched`` over the decoder's full-vocabulary step): the CPU
tests use it, and ``chip_smoke.py`` holds the kernel against it on the card.

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
from typing import Optional, Tuple

import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.ops import cuda_lib
from icee_tpu_torch.ops.att_decode_step import (K_MAX, check_step_params,
                                                step_params, _kind)
from icee_tpu_torch.ops.decode_step import check_kernel_widths


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


def mega_att_beam_decode_steps(
        params: dict, features: torch.Tensor, style: int, batch: int,
        start_token: int = 1, end_token: int = 2, k: int = 5,
        max_seq_length: int = 40, kind: str = "factored"
) -> Tuple[BeamResult, Optional[torch.Tensor]]:
    """:func:`mega_att_beam_decode`, plus the (batch,) int32 count of steps
    each block (image) ran before its early exit (None from the plain
    version on the CPU), which sizes the work for a bound."""
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
                        ("init_c_w", (fs, hd)), ("init_c_b", (hd,)),
                        ("embed", (v, e))):
        t = emb if name == "embed" else params[name]
        cuda_lib.check_tensor(name, t, shape, torch.float32, device)
    if not 1 <= k <= min(K_MAX, v):
        raise ValueError(f"k={k} outside [1, {min(K_MAX, v)}]")
    if device.type == "cpu":
        return mega_att_beam_decode_plain(params, features, int(style), batch,
                                          start_token, end_token, k,
                                          max_seq_length, kind), None
    if device.type != "cuda":
        raise ValueError(f"mega_att_beam_decode: unsupported device {device}")
    check_kernel_widths(f, hd, v, a, fs)

    lib = _library()
    smem = lib.icee_mega_att_beam_smem(e, f, hd, v, k, max_seq_length, a, p,
                                       fs)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(f"mega_att_beam_decode needs {smem} bytes of shared "
                         f"memory per block, more than {cuda_lib.SMEM_LIMIT}")
    att1 = att_mod.att_projection(att, features)
    max_len = max_seq_length + 2
    i32 = dict(dtype=torch.int32, device=device)
    tokens = torch.empty((batch, max_len), **i32)
    length = torch.empty((batch,), **i32)
    score = torch.empty((batch,), dtype=torch.float32, device=device)
    steps = torch.empty((batch,), **i32)
    ptr = cuda_lib.ptr
    head = (ptr(features), ptr(att1), ptr(emb), ptr(att["dec_w"]),
            ptr(att["dec_b"]), ptr(att["full_w"]), ptr(att["full_b"]),
            ptr(gate["f_beta_w"]), ptr(gate["f_beta_b"]),
            *(ptr(params[n]) for n in ("init_h_w", "init_h_b", "init_c_w",
                                       "init_c_b")))
    outs = (ptr(cell["C_w"]), ptr(cell["C_b"]), ptr(tokens), ptr(length),
            ptr(score), ptr(steps), batch, k, e)
    tail = (v, a, p, fs, max_seq_length, start_token, end_token,
            cuda_lib.stream_ptr(device))
    if kind == "factored":
        rc = lib.icee_mega_att_beam_decode(
            *head, *(ptr(cell[n]) for n in ("V_w", "V_b", "S_w", "S_b", "U_w",
                                            "U_b", "W_w", "W_b")),
            *outs, f, hd, *tail)
        mega_att_beam_decode.launches += 1
    else:
        rc = lib.icee_mega_att_beam_decode_lstm(
            *head, *(ptr(cell[n]) for n in ("W_ih", "b_ih", "W_hh", "b_hh")),
            *outs, hd, *tail)
        mega_att_beam_decode.lstm_launches += 1
    cuda_lib.check_rc(lib, rc, f"mega_att_beam_decode (kind={kind})")
    return BeamResult(tokens=tokens, length=length, score=score), steps


mega_att_beam_decode.launches = 0       # kernel launches, kind="factored"
mega_att_beam_decode.lstm_launches = 0  # kernel launches, kind="lstm"


def _library() -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    return cuda_lib.library("att_beam", {
        "icee_mega_att_beam_decode": ([vp] * 27 + [i] * 12 + [vp], i),
        "icee_mega_att_beam_decode_lstm": ([vp] * 23 + [i] * 11 + [vp], i),
        "icee_mega_att_beam_smem": ([i] * 9, ctypes.c_longlong)})
