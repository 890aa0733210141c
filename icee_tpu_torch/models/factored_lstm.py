"""StyleNet FactoredLSTM decoder, inference half (port of
``icee_tpu/models/factored_lstm.py``; the training ``forward`` comes with the
training slice).

Parameters are a plain dict of tensors with the JAX package's keys and
layout.  Init parity with the reference: Xavier-uniform for matrices, zeros
for biases (``model.py:99-105``), then ``B`` and ``C.weight`` ~ U(-0.1, 0.1),
``C.bias`` = 0 (``model.py:107-113``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import DecoderConfig
from icee_tpu_torch.ops.cells import factored_lstm_cell

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each (B, H)


def init_params(generator: torch.Generator, cfg: DecoderConfig,
                dtype=torch.float32, device="cpu") -> dict:
    """Parameter dict for the factored decoder; each stacked slice is drawn
    like the reference's separate ``nn.Linear`` (per-gate Xavier fans)."""
    e_in, f, h, v = (cfg.input_size, cfg.factored_size, cfg.hidden_size,
                     cfg.vocab_size)
    ns = cfg.num_styles
    kw = dict(dtype=dtype, device=device)
    # V: 4 gates of (E_in -> F), stored (E_in, 4F) gate-major on the last axis
    v_w = init.xavier_uniform(generator, (4, e_in, f), **kw)
    v_w = v_w.permute(1, 0, 2).reshape(e_in, 4 * f).contiguous()
    s_w = init.xavier_uniform(generator, (ns, 4, f, f), **kw)
    u_w = init.xavier_uniform(generator, (4, f, h), **kw)
    w_w = init.xavier_uniform(generator, (4, h, h), **kw)
    w_w = w_w.permute(1, 0, 2).reshape(h, 4 * h).contiguous()
    return {
        "B": init.uniform(generator, (v, cfg.embed_size), 0.1, **kw),
        "V_w": v_w,
        "V_b": init.zeros((4, f), **kw),
        "S_w": s_w,
        "S_b": init.zeros((ns, 4, f), **kw),
        "U_w": u_w,
        "U_b": init.zeros((4, h), **kw),
        "W_w": w_w,
        "W_b": init.zeros((4, h), **kw),
        "C_w": init.uniform(generator, (h, v), 0.1, **kw),
        "C_b": init.zeros((v,), **kw),
    }


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["B"][tokens.long()]


def output_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ params["C_w"] + params["C_b"]


def initial_state(batch: int, cfg: DecoderConfig, dtype=torch.float32,
                  device="cpu") -> State:
    z = torch.zeros((batch, cfg.hidden_size), dtype=dtype, device=device)
    return z, z.clone()


def decode_step(params: dict, x: torch.Tensor, state: State,
                style: int) -> Tuple[torch.Tensor, State]:
    """One inference step: input embedding/feature -> vocab logits
    (``model.py:222-231`` inner loop)."""
    h, c = state
    h, c = factored_lstm_cell(params, x, h, c, style)
    return output_logits(params, h), (h, c)
