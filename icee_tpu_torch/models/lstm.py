"""NIC (Show-and-Tell) decoder and the generic multi-layer LSTM step (port of
``icee_tpu/models/lstm.py``).

Parity targets: ``DecoderRNN`` (``nic/model.py:30-207``), the StyleNet
scaffolding with a stock ``nn.LSTMCell``, and the multi-layer ``nn.LSTM``
step of the seq2seq family (``seq2seq/model.py:46-66``).

Parameters are a plain dict with the JAX package's keys and layout:
``{"embed" (V, E), "cell": {"W_ih" (E, 4H), "W_hh" (H, 4H), "b_ih",
"b_hh" (4H,)}, "linear_w" (H, V), "linear_b" (V,)}``, gate order
[i, f, g, o].  Init parity (``nic/model.py:56-70``): Xavier for the cell
matrices with torch's fans of the (4H, in) layout, zero biases, ``embed``
and ``linear_w`` ~ U(-0.1, 0.1), ``linear_b`` = 0.

Randomness as in :mod:`icee_tpu_torch.models.factored_lstm`: the dropout
keep-mask and the teacher-forcing coins come from a ``torch.Generator`` or
are passed in (``keep``, ``coins``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import DecoderConfig
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.ops.cells import lstm_cell, multilayer_lstm_cell
from icee_tpu_torch.ops.nic_scan import fused_nic_scan

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c)


def _xavier_lstm_matrix(generator: torch.Generator, in_dim: int, h_dim: int,
                        dtype, device) -> torch.Tensor:
    """Xavier-uniform for a torch LSTM weight of shape (4H, in), stored
    transposed as (in, 4H): fan_in = in, fan_out = 4H."""
    a = math.sqrt(6.0 / (in_dim + 4 * h_dim))
    return init.uniform(generator, (in_dim, 4 * h_dim), a, dtype, device)


def init_cell_params(generator: torch.Generator, in_dim: int, h_dim: int,
                     dtype=torch.float32, xavier: bool = True,
                     device="cpu") -> dict:
    """One LSTM cell/layer.  ``xavier=True`` matches the reference's explicit
    reset (``nic/model.py:56-63``); ``xavier=False`` keeps torch's default
    U(-1/sqrt(H), 1/sqrt(H)) (seq2seq, which never resets)."""
    kw = dict(dtype=dtype, device=device)
    if xavier:
        return {
            "W_ih": _xavier_lstm_matrix(generator, in_dim, h_dim, **kw),
            "W_hh": _xavier_lstm_matrix(generator, h_dim, h_dim, **kw),
            "b_ih": init.zeros((4 * h_dim,), **kw),
            "b_hh": init.zeros((4 * h_dim,), **kw),
        }
    return {
        "W_ih": init.torch_linear_default(generator, (in_dim, 4 * h_dim),
                                          h_dim, **kw),
        "W_hh": init.torch_linear_default(generator, (h_dim, 4 * h_dim),
                                          h_dim, **kw),
        "b_ih": init.torch_linear_default(generator, (4 * h_dim,), h_dim,
                                          **kw),
        "b_hh": init.torch_linear_default(generator, (4 * h_dim,), h_dim,
                                          **kw),
    }


def init_params(generator: torch.Generator, cfg: DecoderConfig,
                dtype=torch.float32, device="cpu") -> dict:
    """NIC decoder parameters (one LSTMCell whatever ``num_layers``, as in
    ``nic/model.py:51``)."""
    e, h, v = cfg.embed_size, cfg.hidden_size, cfg.vocab_size
    kw = dict(dtype=dtype, device=device)
    return {
        "embed": init.uniform(generator, (v, e), 0.1, **kw),
        "cell": init_cell_params(generator, e, h, xavier=True, **kw),
        "linear_w": init.uniform(generator, (h, v), 0.1, **kw),
        "linear_b": init.zeros((v,), **kw),
    }


def embed(params: dict, tokens: torch.Tensor, vocab=None) -> torch.Tensor:
    """Rows of ``embed``; ``vocab`` as in
    :func:`icee_tpu_torch.models.factored_lstm.embed`."""
    if vocab is not None:
        return vocab.embed(params["embed"], tokens)
    return params["embed"][tokens.long()]


def output_logits(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return hidden @ params["linear_w"] + params["linear_b"]


def initial_state(batch: int, cfg: DecoderConfig, dtype=torch.float32,
                  device="cpu") -> State:
    z = torch.zeros((batch, cfg.hidden_size), dtype=dtype, device=device)
    return z, z.clone()


def decode_step(params: dict, x: torch.Tensor,
                state: State) -> Tuple[torch.Tensor, State]:
    """One inference step: input embedding/feature -> vocab logits."""
    h, c = lstm_cell(params["cell"], x, *state)
    return output_logits(params, h), (h, c)


def _prep_forward(params, cfg, captions, features, teacher_forcing_ratio,
                  generator, train, keep, coins, vocab=None):
    """-> (teacher inputs (B, T, E), coins or None, zero state); the
    factored decoder's prologue over this decoder's embedding."""
    return fl.prepare_inputs(embed(params, captions, vocab), cfg, captions,
                             features, teacher_forcing_ratio, generator,
                             train, keep, coins)


def _scheduled(params, teacher_inputs, coins, state, prev, head_grad,
               vocab=None):
    return fl.scheduled_loop(
        lambda x, h, c: lstm_cell(params["cell"], x, h, c),
        lambda t: embed(params, t, vocab),
        lambda h: output_logits(params, h), teacher_inputs, coins, state,
        prev, head_grad, vocab)


def forward(params: dict, cfg: DecoderConfig, captions: torch.Tensor,
            features: Optional[torch.Tensor],
            teacher_forcing_ratio: float = 0.8,
            generator: Optional[torch.Generator] = None, train: bool = True,
            fused_scan: bool = False, keep=None,
            coins: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Training forward -> logits (B, T, V); the factored decoder's
    semantics (feature prepended as the step-0 input, ``nic/model.py:
    82-111``).  At ratio < 1 the head keeps its gradient on every step."""
    if fl._teacher_forced(teacher_forcing_ratio):
        hiddens = forward_hiddens(params, cfg, captions, features,
                                  teacher_forcing_ratio, generator, train,
                                  fused_scan, keep, coins)
        return hiddens @ params["linear_w"] + params["linear_b"]
    teacher_inputs, coins, state = _prep_forward(
        params, cfg, captions, features, teacher_forcing_ratio, generator,
        train, keep, coins)
    _, logits = _scheduled(params, teacher_inputs, coins, state,
                           captions[:, 0], head_grad=True)
    return logits


def forward_hiddens(params: dict, cfg: DecoderConfig, captions: torch.Tensor,
                    features: Optional[torch.Tensor],
                    teacher_forcing_ratio: float = 0.8,
                    generator: Optional[torch.Generator] = None,
                    train: bool = True, fused_scan: bool = False, keep=None,
                    coins: Optional[Sequence[bool]] = None,
                    vocab=None) -> torch.Tensor:
    """Training forward -> hidden states (B, T, H), the vocab head left to
    the caller (the chunked loss); ``vocab`` as in
    :func:`icee_tpu_torch.models.factored_lstm.forward_hiddens`.

    On the teacher-forced path (ratio >= 1) ``fused_scan`` runs the K4 scan
    (``ops/nic_scan.py``) for any batch size; otherwise the cell loop in
    PyTorch.  On the scheduled-sampling path the head runs per step on the
    detached hidden state only to pick the argmax feedback token
    (``models/lstm.py:213``)."""
    teacher_inputs, coins, state = _prep_forward(
        params, cfg, captions, features, teacher_forcing_ratio, generator,
        train, keep, coins, vocab)
    if coins is None:
        if fused_scan:
            return fused_nic_scan(params["cell"], teacher_inputs)
        h, c = state
        hs = []
        for step in range(teacher_inputs.shape[1]):
            h, c = lstm_cell(params["cell"], teacher_inputs[:, step], h, c)
            hs.append(h)
        return torch.stack(hs, 1)
    hiddens, _ = _scheduled(params, teacher_inputs, coins, state,
                            captions[:, 0], head_grad=False, vocab=vocab)
    return hiddens


# --- multi-layer LSTM (seq2seq building block) -------------------------------

def init_multilayer(generator: torch.Generator, in_dim: int, h_dim: int,
                    num_layers: int, dtype=torch.float32, xavier: bool = False,
                    device="cpu") -> List[dict]:
    """torch ``nn.LSTM(in, H, num_layers)`` parameter stack."""
    return [init_cell_params(generator, in_dim if i == 0 else h_dim, h_dim,
                             dtype, xavier, device)
            for i in range(num_layers)]


def multilayer_initial_state(num_layers: int, batch: int, h_dim: int,
                             dtype=torch.float32, device="cpu") -> State:
    z = torch.zeros((num_layers, batch, h_dim), dtype=dtype, device=device)
    return z, z.clone()


def multilayer_decode_step(params_layers: List[dict], x: torch.Tensor,
                           state: State) -> Tuple[torch.Tensor, State]:
    top, h, c = multilayer_lstm_cell(params_layers, x, *state)
    return top, (h, c)
