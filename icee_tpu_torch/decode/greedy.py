"""Greedy decoding as a fixed-length loop (port of
``icee_tpu/decode/greedy.py``).

Used by the standalone validator's sampling path (``stylenet/validate.py``);
the reference's greedy loops live in ``seq2seq/model.py:100-122,193-217``.
JAX runs it as a ``lax.scan`` in XLA, with no Pallas kernel: here it is a
plain loop over ``step_fn`` on the tensors' device.
"""

from __future__ import annotations

from typing import Callable

import torch


def greedy_decode(embed_fn: Callable[[torch.Tensor], torch.Tensor],
                  step_fn: Callable, init_state, first_input: torch.Tensor,
                  max_steps: int) -> torch.Tensor:
    """Roll out argmax tokens.

    ``step_fn(x, state) -> (logits, state)``; ``first_input`` is the step-0
    input (image feature or start-token embedding), the argmax token's
    embedding every step after.  Returns (B, max_steps) token ids.
    """
    state, x = init_state, first_input
    toks = []
    for _ in range(max_steps):
        logits, state = step_fn(x, state)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        x = embed_fn(tok)
    if not toks:
        return torch.zeros((first_input.shape[0], 0), dtype=torch.long,
                           device=first_input.device)
    return torch.stack(toks, 1)
