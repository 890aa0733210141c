"""Attention decoders, StyleNet+Att and NIC+Att (port of the inference half
of ``icee_tpu/models/attention.py``).

Parity targets: ``Attention`` and ``DecoderFactoredLSTMAtt``
(``stylenet/model_att.py:32-426``) and ``DecoderRNNAtt``
(``nic/model_att.py:73-306``):

- additive attention over the 14 x 14 = 196 spatial grid
  (``model_att.py:51-70``), one attention net per style for the factored
  decoder, stacked into ``(num_styles, ...)`` tensors and selected by the
  style id; one net for NIC+Att, which ignores the style,
- a sigmoid gate ``f_beta(h)`` on the context (``:283-284``),
- h and c from the mean image feature (``:185-194``),
- per-step input ``[word_emb ; gated context]`` (``:290``).

Parameters are plain dicts with the JAX package's keys and layout; the
factored decoder's cell tensors are :func:`~icee_tpu_torch.models.
factored_lstm.init_params`' with the widened input (E + feature_size), the
NIC+Att cell :func:`~icee_tpu_torch.models.lstm.init_cell_params`'.  The
training forward comes with the attention training scan (K5).
"""

from __future__ import annotations

from typing import Tuple

import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import AttentionDecoderConfig
from icee_tpu_torch.ops.cells import factored_lstm_cell, lstm_cell

State = Tuple[torch.Tensor, torch.Tensor]  # (h, c)


# --- additive attention ---------------------------------------------------

def init_attention(generator: torch.Generator, enc_dim: int, dec_dim: int,
                   att_dim: int, dtype=torch.float32, device="cpu") -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "enc_w": init.xavier_uniform(generator, (enc_dim, att_dim), **kw),
        "enc_b": init.zeros((att_dim,), **kw),
        "dec_w": init.xavier_uniform(generator, (dec_dim, att_dim), **kw),
        "dec_b": init.zeros((att_dim,), **kw),
        "full_w": init.xavier_uniform(generator, (att_dim, 1), **kw),
        "full_b": init.zeros((1,), **kw),
    }


def attend(att: dict, features: torch.Tensor, hidden: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """features (B, P, enc_dim), hidden (B, dec_dim) -> (context (B,
    enc_dim), alpha (B, P)) — ``model_att.py:51-70``."""
    att1 = features @ att["enc_w"] + att["enc_b"]            # (B, P, A)
    return attend_precomputed(att, att1, features, hidden)


def attend_precomputed(att: dict, att1: torch.Tensor, features: torch.Tensor,
                       hidden: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with the encoder projection ``att1 = features @ enc_w +
    enc_b`` hoisted out of the time loop (it does not depend on h)."""
    att2 = hidden @ att["dec_w"] + att["dec_b"]              # (B, A)
    e = torch.relu(att1 + att2[:, None, :]) @ att["full_w"]  # (B, P, 1)
    e = e[..., 0] + att["full_b"]
    alpha = torch.softmax(e, dim=1)
    context = torch.sum(features * alpha[..., None], dim=1)
    return context, alpha


def _stack_attention(generator: torch.Generator, n: int, enc_dim: int,
                     dec_dim: int, att_dim: int, dtype, device) -> dict:
    atts = [init_attention(generator, enc_dim, dec_dim, att_dim, dtype,
                           device) for _ in range(n)]
    return {k: torch.stack([a[k] for a in atts]) for k in atts[0]}


def _select_attention(stacked: dict, style: int) -> dict:
    return {k: v[int(style)] for k, v in stacked.items()}


def select_attention(params: dict, style: int) -> dict:
    """The attention net a decoder uses for ``style``: the style's slice of
    the stacked nets (StyleNet+Att), or the one net (NIC+Att)."""
    if params["attention"]["enc_w"].dim() == 3:
        return _select_attention(params["attention"], style)
    return params["attention"]


def att_projection(att: dict, features: torch.Tensor) -> torch.Tensor:
    """``att1 = features @ enc_w + enc_b`` (B, P, A), one product per image:
    a GEMM library may pick another summation order for another row count,
    and a served caption must not depend on how many images share its
    decode."""
    return torch.stack([torch.addmm(att["enc_b"], f, att["enc_w"])
                        for f in features])


# --- StyleNet factored attention decoder ----------------------------------

def _init_extras(generator: torch.Generator, cfg: AttentionDecoderConfig,
                 dtype, device) -> dict:
    fs, hs = cfg.feature_size, cfg.hidden_size
    kw = dict(dtype=dtype, device=device)
    return {
        "init_h_w": init.xavier_uniform(generator, (fs, hs), **kw),
        "init_h_b": init.zeros((hs,), **kw),
        "init_c_w": init.xavier_uniform(generator, (fs, hs), **kw),
        "init_c_b": init.zeros((hs,), **kw),
        "f_beta_w": init.xavier_uniform(generator, (hs, fs), **kw),
        "f_beta_b": init.zeros((fs,), **kw),
    }


def init_factored_att_params(generator: torch.Generator,
                             cfg: AttentionDecoderConfig,
                             dtype=torch.float32, device="cpu") -> dict:
    """DecoderFactoredLSTMAtt parameters: the factored cell with the
    widened input (E + feature_size), one attention net per style, the h/c
    init projections and the context gate."""
    from icee_tpu_torch.models import factored_lstm

    params = factored_lstm.init_params(generator, cfg, dtype, device)
    params["attention"] = _stack_attention(
        generator, cfg.num_styles, cfg.feature_size, cfg.hidden_size,
        cfg.attention_size, dtype, device)
    params.update(_init_extras(generator, cfg, dtype, device))
    return params


def init_rnn_att_params(generator: torch.Generator,
                        cfg: AttentionDecoderConfig, dtype=torch.float32,
                        device="cpu") -> dict:
    """DecoderRNNAtt: one attention net + LSTMCell(E + feature_size -> H)
    (``nic/model_att.py:73-161``), Xavier reset."""
    from icee_tpu_torch.models.lstm import init_cell_params

    kw = dict(dtype=dtype, device=device)
    fs, hs = cfg.feature_size, cfg.hidden_size
    params = {
        "embed": init.uniform(generator, (cfg.vocab_size, cfg.embed_size),
                              0.1, **kw),
        "cell": init_cell_params(generator, cfg.embed_size + fs, hs,
                                 xavier=True, **kw),
        "linear_w": init.uniform(generator, (hs, cfg.vocab_size), 0.1, **kw),
        "linear_b": init.zeros((cfg.vocab_size,), **kw),
        "attention": init_attention(generator, fs, hs, cfg.attention_size,
                                    **kw),
    }
    params.update(_init_extras(generator, cfg, dtype, device))
    return params


def init_hidden_state(params: dict, features: torch.Tensor) -> State:
    """h/c from the mean spatial feature (``model_att.py:185-194``).
    features: (B, P, enc_dim)."""
    mean = torch.mean(features, dim=1)
    h = mean @ params["init_h_w"] + params["init_h_b"]
    c = mean @ params["init_c_w"] + params["init_c_b"]
    return h, c


def _gated_context(params: dict, att: dict, features: torch.Tensor,
                   h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    context, alpha = attend(att, features, h)
    gate = torch.sigmoid(h @ params["f_beta_w"] + params["f_beta_b"])
    return gate * context, alpha


def _gated_context_pre(params: dict, att: dict, att1: torch.Tensor,
                       features: torch.Tensor, h: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    context, alpha = attend_precomputed(att, att1, features, h)
    gate = torch.sigmoid(h @ params["f_beta_w"] + params["f_beta_b"])
    return gate * context, alpha


def factored_att_decode_step(params: dict, emb: torch.Tensor,
                             features: torch.Tensor, state: State,
                             style: int, att1=None
                             ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """One inference step -> (logits, alpha, new_state)
    (``model_att.py:348-364``).  ``att1``: the hoisted encoder projection of
    the style's net, or None to compute it here."""
    from icee_tpu_torch.models.factored_lstm import output_logits

    h, c = state
    att = _select_attention(params["attention"], style)
    if att1 is None:
        att1 = features @ att["enc_w"] + att["enc_b"]
    context, alpha = _gated_context_pre(params, att, att1, features, h)
    x = torch.cat([emb, context], dim=-1)
    h, c = factored_lstm_cell(params, x, h, c, style)
    return output_logits(params, h), alpha, (h, c)


def rnn_att_decode_step(params: dict, emb: torch.Tensor,
                        features: torch.Tensor, state: State, att1=None
                        ) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """One NIC+Att inference step -> (logits, alpha, new_state)."""
    h, c = state
    att = params["attention"]
    if att1 is None:
        att1 = features @ att["enc_w"] + att["enc_b"]
    context, alpha = _gated_context_pre(params, att, att1, features, h)
    x = torch.cat([emb, context], dim=-1)
    h, c = lstm_cell(params["cell"], x, h, c)
    logits = h @ params["linear_w"] + params["linear_b"]
    return logits, alpha, (h, c)
