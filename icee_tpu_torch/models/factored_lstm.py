"""StyleNet FactoredLSTM decoder (port of
``icee_tpu/models/factored_lstm.py``): inference steps and the training
forward.

Parameters are a plain dict of tensors with the JAX package's keys and
layout.  Init parity with the reference: Xavier-uniform for matrices, zeros
for biases (``model.py:99-105``), then ``B`` and ``C.weight`` ~ U(-0.1, 0.1),
``C.bias`` = 0 (``model.py:107-113``).

Randomness: the dropout keep-mask and the per-step teacher-forcing coins are
drawn from a ``torch.Generator`` (on the generator's device, then moved), or
passed in explicitly (``keep``, ``coins``), which is how the tests hand the
port the JAX package's draws: torch cannot reproduce ``jax.random``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import DecoderConfig
from icee_tpu_torch.ops.cells import factored_lstm_cell
from icee_tpu_torch.ops.lstm_scan import fused_factored_scan

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


def _teacher_forced(ratio) -> bool:
    return float(ratio) >= 1.0


def _prep_forward(params, cfg, captions, features, teacher_forcing_ratio,
                  generator, train, keep, coins):
    """Shared training-forward prologue -> (teacher inputs (B, T, E) with
    the feature prepended and dropout applied to the embeddings only, the
    per-step coins as a host list or None on the teacher-forced path, the
    zero initial state)."""
    b, t = captions.shape
    device = captions.device
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    emb = embed(params, captions)                            # (B, T, E)
    if train and cfg.dropout > 0.0:
        if keep is None:
            keep = torch.rand(tuple(emb.shape), generator=generator,
                              device=generator.device) < 1.0 - cfg.dropout
        keep = torch.as_tensor(keep, device=device).bool()
        emb = torch.where(keep, emb / (1.0 - cfg.dropout), 0.0)
    if features is not None:
        teacher_inputs = torch.cat(
            [features[:, None, :].to(emb.dtype), emb[:, :-1]], dim=1)
    else:
        teacher_inputs = emb
    if _teacher_forced(teacher_forcing_ratio):
        coins = None
    else:
        if coins is None:
            coins = torch.rand((t,), generator=generator,
                               device=generator.device) < teacher_forcing_ratio
        coins = [bool(c) for c in torch.as_tensor(coins).cpu().tolist()]
    return teacher_inputs, coins, initial_state(b, cfg, emb.dtype, device)


def _scheduled(params, teacher_inputs, coins: List[bool], state, prev,
               style: int, head_grad: bool):
    """The scheduled-sampling loop: on a free step the input is the
    UN-dropped embedding of the previous argmax (``model.py:180-191``).
    -> (hiddens (B, T, H), logits (B, T, V) or None)."""
    h, c = state
    hs, logits_all = [], []
    for step, coin in enumerate(coins):
        x = teacher_inputs[:, step] if coin else embed(params, prev)
        h, c = factored_lstm_cell(params, x, h, c, style)
        logits = output_logits(params, h if head_grad else h.detach())
        prev = torch.argmax(logits, dim=-1)                  # first maximum
        hs.append(h)
        if head_grad:
            logits_all.append(logits)
    hiddens = torch.stack(hs, 1)
    return hiddens, (torch.stack(logits_all, 1) if head_grad else None)


def forward(params: dict, cfg: DecoderConfig, captions: torch.Tensor,
            features: Optional[torch.Tensor], style: int,
            teacher_forcing_ratio: float = 0.8,
            generator: Optional[torch.Generator] = None, train: bool = True,
            fused_scan: bool = False, keep=None,
            coins: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Teacher-forced/scheduled training forward -> logits (B, T, V).

    Step ``t`` predicts ``captions[:, t]``; with ``features`` step 0
    consumes the image feature and step t>=1 the embedding of
    ``captions[:, t-1]``; without, step t consumes ``captions[:, t]``.  One
    coin per timestep, shared across the batch; ``teacher_forcing_ratio=0``
    is the fully free-running validation path.
    """
    if _teacher_forced(teacher_forcing_ratio):
        hiddens = forward_hiddens(params, cfg, captions, features, style,
                                  teacher_forcing_ratio, generator, train,
                                  fused_scan, keep, coins)
        return hiddens @ params["C_w"] + params["C_b"]
    teacher_inputs, coins, state = _prep_forward(
        params, cfg, captions, features, teacher_forcing_ratio, generator,
        train, keep, coins)
    _, logits = _scheduled(params, teacher_inputs, coins, state,
                           captions[:, 0], int(style), head_grad=True)
    return logits


def forward_hiddens(params: dict, cfg: DecoderConfig, captions: torch.Tensor,
                    features: Optional[torch.Tensor], style: int,
                    teacher_forcing_ratio: float = 0.8,
                    generator: Optional[torch.Generator] = None,
                    train: bool = True, fused_scan: bool = False, keep=None,
                    coins: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Training forward -> hidden states (B, T, H); :func:`forward`'s
    semantics with the vocab head left to the caller (the chunked loss).

    On the teacher-forced path (ratio >= 1) ``fused_scan`` runs the K3
    scan (``ops/lstm_scan.py``) for any batch size; otherwise the cell loop
    in PyTorch.  On the scheduled-sampling path the head runs per step on
    the detached hidden state only to pick the argmax feedback token.
    """
    teacher_inputs, coins, state = _prep_forward(
        params, cfg, captions, features, teacher_forcing_ratio, generator,
        train, keep, coins)
    style = int(style)
    if coins is None:
        if fused_scan:
            sliced = {k: params[k] for k in
                      ("V_w", "V_b", "U_w", "U_b", "W_w", "W_b")}
            sliced["S_w"] = params["S_w"][style]
            sliced["S_b"] = params["S_b"][style]
            return fused_factored_scan(sliced, teacher_inputs)
        h, c = state
        hs = []
        for step in range(teacher_inputs.shape[1]):
            h, c = factored_lstm_cell(params, teacher_inputs[:, step], h, c,
                                      style)
            hs.append(h)
        return torch.stack(hs, 1)
    hiddens, _ = _scheduled(params, teacher_inputs, coins, state,
                            captions[:, 0], style, head_grad=False)
    return hiddens


def style_param_mask(params: dict, include_output_head: bool = True) -> dict:
    """Boolean mask dict selecting the style S tensors (+ optionally the
    output head C): the transfer fine-tuner's parameter group
    (``stylenet/train_transfer.py:94-115``)."""
    mask = {k: False for k in params}
    mask["S_w"] = True
    mask["S_b"] = True
    if include_output_head:
        mask["C_w"] = True
        mask["C_b"] = True
    return mask
