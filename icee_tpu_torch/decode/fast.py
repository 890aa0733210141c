"""The beam decode paths (port of ``icee_tpu/decode/fast.py``'s
``factored_candidates`` and ``nic_candidates``).

The JAX package probes a chain of candidates (mega kernel -> per-step fused
kernel -> XLA) and falls through on any exception.  Here the caller names
the path, and nothing falls back:

- ``"mega"``: the whole search in one K2 launch (``ops/beam.py``),
- ``"fused-step"``: :func:`~icee_tpu_torch.decode.beam.beam_search_batched`
  driving the K1 step kernel (``ops/decode_step.py``) once per step.

Both are token-identical on the card (they share the kernels' device
functions) and on the CPU (where both wrappers take their plain versions).

The NIC decoder has one path, :func:`nic_decode`: K2 with ``cell="lstm"``.
The JAX package's only other NIC candidate is the plain XLA beam, which
here is K2's plain version (the CPU path).
"""

from __future__ import annotations

from typing import Optional

import torch

from icee_tpu_torch.decode.beam import BeamResult, beam_search_batched
from icee_tpu_torch.models import factored_lstm as fl

PATHS = ("mega", "fused-step")


def factored_decode(
    path: str,
    dec_params: dict,
    feats: Optional[torch.Tensor],
    style: int,
    batch: int,
    k: int,
    max_seq_length: int,
    start_token: int,
    end_token: int,
) -> BeamResult:
    """Beam-decode ``batch`` images through ``path``.

    ``feats`` (batch, k, E) is the step-1 input (serving semantics); None
    decodes with the research semantics (``<start>`` embedded at step 1).
    """
    if path == "mega":
        from icee_tpu_torch.ops.beam import mega_beam_decode

        return mega_beam_decode(
            dec_params, feats, style, batch, start_token=start_token,
            end_token=end_token, k=k, max_seq_length=max_seq_length)
    if path == "fused-step":
        from icee_tpu_torch.ops.decode_step import decode_step_topk

        def topk_step(x, state):
            h, c = state
            vals, idx, h2, c2 = decode_step_topk(dec_params, x, h, c, style,
                                                 ktop=k)
            return vals, idx, (h2, c2)

        hd = dec_params["W_w"].shape[0]
        zeros = torch.zeros((batch * k, hd), dtype=dec_params["C_w"].dtype,
                            device=dec_params["C_w"].device)
        return beam_search_batched(
            embed_fn=lambda t: fl.embed(dec_params, t), step_fn=None,
            init_model_state=(zeros, zeros.clone()),
            start_token=start_token, end_token=end_token, k=k,
            max_seq_length=max_seq_length,
            vocab_size=dec_params["C_w"].shape[1], batch=batch,
            first_input=feats, step_topk_fn=topk_step)
    raise ValueError(f"unknown decode path {path!r}; choose one of {PATHS}")


def nic_decode(
    dec_params: dict,
    feats: Optional[torch.Tensor],
    batch: int,
    k: int,
    max_seq_length: int,
    start_token: int,
    end_token: int,
) -> BeamResult:
    """Beam-decode ``batch`` images with the NIC decoder in one K2 launch
    (``cell="lstm"``); ``feats`` as in :func:`factored_decode`."""
    from icee_tpu_torch.ops.beam import mega_beam_decode

    return mega_beam_decode(
        dec_params, feats, 0, batch, start_token=start_token,
        end_token=end_token, k=k, max_seq_length=max_seq_length, cell="lstm")
