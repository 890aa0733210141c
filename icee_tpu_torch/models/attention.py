"""Attention decoders, StyleNet+Att and NIC+Att (port of
``icee_tpu/models/attention.py``): inference steps and the training
forward.

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
NIC+Att cell :func:`~icee_tpu_torch.models.lstm.init_cell_params`'.

The training forward (:func:`factored_att_forward`, :func:`rnn_att_forward`
and their ``_hiddens`` forms) runs on CUDA through the K5 scan
(``ops/att_scan.py``) with ``fused_scan``: teacher-forced at ratio >= 1,
scheduled sampling below, for any batch size.  The dropout keep-mask and
the per-step coins come from a ``torch.Generator`` or are passed in
(``keep``, ``coins``), as in ``models/factored_lstm.py``.  The encoder
projection ``att1`` and ``init_hidden_state`` stay plain torch with
autograd, so the grads of ``enc_w`` and the h/c init flow through att1, h0
and c0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import AttentionDecoderConfig
from icee_tpu_torch.ops import att_scan
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


# --- training forward -------------------------------------------------------

def _factored_kernel_params(params: dict, att: dict, style: int, e: int):
    """The factored decoder's and the style's attention tensors in K5's
    layout (V_w split at the embedding/context boundary, the style's S
    slice); autograd carries the grads back into ``params``."""
    cell = {"V_we": params["V_w"][:e], "V_wc": params["V_w"][e:],
            "V_b": params["V_b"], "S_w": params["S_w"][int(style)],
            "S_b": params["S_b"][int(style)], "U_w": params["U_w"],
            "U_b": params["U_b"], "W_w": params["W_w"], "W_b": params["W_b"]}
    return cell, _kernel_att(params, att)


def _lstm_kernel_params(params: dict, att: dict, e: int):
    w_ih = params["cell"]["W_ih"]
    cell = {"W_ihe": w_ih[:e], "W_ihc": w_ih[e:],
            "W_hh": params["cell"]["W_hh"], "b_ih": params["cell"]["b_ih"],
            "b_hh": params["cell"]["b_hh"]}
    return cell, _kernel_att(params, att)


def _kernel_att(params: dict, att: dict) -> dict:
    return {"dec_w": att["dec_w"], "dec_b": att["dec_b"],
            "full_w": att["full_w"], "full_b": att["full_b"],
            "fb_w": params["f_beta_w"], "fb_b": params["f_beta_b"]}


class _Family:
    """What differs between the two decoders: the embedding table, the
    cell, the head and K5's parameter layout."""

    def __init__(self, params: dict, cfg, style: int, factored: bool,
                 vocab=None):
        self.params, self.cfg, self.style = params, cfg, int(style)
        self.factored = factored
        self.vocab = vocab
        self.table = params["B"] if factored else params["embed"]
        self.head_w, self.head_b = ((params["C_w"], params["C_b"])
                                    if factored else
                                    (params["linear_w"], params["linear_b"]))

    def embed(self, tokens):
        if self.vocab is not None:
            return self.vocab.embed(self.table, tokens)
        return self.table[tokens.long()]

    def argmax(self, logits):
        if self.vocab is not None:
            return self.vocab.argmax(logits)
        return torch.argmax(logits, dim=-1)              # first maximum

    def whole_head(self) -> dict:
        """K5's sampled scan reads the whole head and table (its argmax
        and the fed-back rows): with ``vocab`` gathered from the slices,
        each slice's gradient its part of the whole's."""
        if self.vocab is None:
            return {"C_w": self.head_w, "C_b": self.head_b, "B": self.table}
        return {"C_w": self.vocab.whole(self.head_w, 1),
                "C_b": self.vocab.whole(self.head_b, 0),
                "B": self.vocab.whole(self.table, 0)}

    def cell(self, x, h, c):
        if self.factored:
            return factored_lstm_cell(self.params, x, h, c, self.style)
        return lstm_cell(self.params["cell"], x, h, c)

    def logits(self, h):
        return h @ self.head_w + self.head_b

    def kernel_params(self, att: dict):
        if self.factored:
            return _factored_kernel_params(self.params, att, self.style,
                                           self.cfg.embed_size)
        return _lstm_kernel_params(self.params, att, self.cfg.embed_size)


def _train_forward(fam: _Family, captions, features, teacher_forcing_ratio,
                   generator, train, fused_scan, keep, coins, head_grad):
    """The attention decoders' training forward -> (hiddens, or logits with
    ``head_grad``, (B, T, .); alphas (B, T, P)).

    The embeddings get dropout (``keep`` or a draw from ``generator``);
    at ratio < 1 one coin per step, shared by the batch, picks the teacher's
    input or the raw embedding of the previous step's argmax (the head runs
    on the detached h unless ``head_grad``).  ``fused_scan`` runs K5 instead
    of the cell loop; K5 returns hidden states, so callers with
    ``head_grad`` pass it False."""
    from icee_tpu_torch.models.factored_lstm import prepare_inputs

    emb_seq, coins, _ = prepare_inputs(
        fam.embed(captions), fam.cfg, captions, None, teacher_forcing_ratio,
        generator, train, keep, coins)
    att = select_attention(fam.params, fam.style)
    att1 = features @ att["enc_w"] + att["enc_b"]
    h0, c0 = init_hidden_state(fam.params, features)
    kind = "factored" if fam.factored else "lstm"
    if fused_scan:
        cell, katt = fam.kernel_params(att)
        if coins is None:
            return att_scan.fused_att_scan(cell, katt, emb_seq, att1,
                                           features, h0, c0, kind)
        head = fam.whole_head()
        coin_t = torch.tensor(coins, dtype=torch.float32,
                              device=emb_seq.device)
        # only the t = 0 bootstrap column of the raw embeddings is consumed
        return att_scan.fused_att_scan_sampled(
            cell, katt, head, emb_seq, fam.embed(captions[:, :1]), att1,
            features, h0, c0, coin_t, kind)
    h, c = h0, c0
    prev = captions[:, 0]
    outs, alphas = [], []
    for step in range(emb_seq.shape[1]):
        gctx, alpha = _gated_context_pre(fam.params, att, att1, features, h)
        e = (emb_seq[:, step] if coins is None or coins[step]
             else fam.embed(prev))
        h, c = fam.cell(torch.cat([e, gctx], dim=-1), h, c)
        if head_grad:
            logits = fam.logits(h)
            outs.append(logits)
        else:
            outs.append(h)
            if coins is not None:
                logits = fam.logits(h.detach())
        if coins is not None:
            prev = fam.argmax(logits)
        alphas.append(alpha)
    return torch.stack(outs, 1), torch.stack(alphas, 1)


def factored_att_forward(params: dict, cfg: AttentionDecoderConfig,
                         captions: torch.Tensor, features: torch.Tensor,
                         style: int, teacher_forcing_ratio: float = 0.8,
                         generator: Optional[torch.Generator] = None,
                         train: bool = True, fused_scan: bool = False,
                         keep=None, coins: Optional[Sequence[bool]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """StyleNet+Att training forward -> (logits (B, T, V), alphas (B, T, P))
    (``model_att.py:238-305``); the trainer passes the shifted captions.
    At ratio >= 1 the head runs on the hidden states (K5 with
    ``fused_scan``); below, per step with its gradient."""
    fam = _Family(params, cfg, style, True)
    return _forward_logits(fam, captions, features, teacher_forcing_ratio,
                           generator, train, fused_scan, keep, coins)


def _forward_logits(fam, captions, features, ratio, generator, train,
                    fused_scan, keep, coins):
    if float(ratio) >= 1.0:
        hiddens, alphas = _train_forward(fam, captions, features, ratio,
                                         generator, train, fused_scan, keep,
                                         coins, head_grad=False)
        return fam.logits(hiddens), alphas
    return _train_forward(fam, captions, features, ratio, generator, train,
                          False, keep, coins, head_grad=True)


def factored_att_forward_hiddens(params: dict, cfg: AttentionDecoderConfig,
                                 captions: torch.Tensor,
                                 features: torch.Tensor, style: int,
                                 teacher_forcing_ratio: float = 0.8,
                                 generator: Optional[torch.Generator] = None,
                                 train: bool = True, fused_scan: bool = False,
                                 keep=None,
                                 coins: Optional[Sequence[bool]] = None,
                                 vocab=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """StyleNet+Att training forward -> (hiddens (B, T, H), alphas); the
    vocab head is left to the caller (the chunked loss).  ``fused_scan``
    runs K5, teacher-forced or sampled.  ``vocab``: ``B`` and the head hold
    this rank's slice of a vocabulary split over the mesh's model group
    (:func:`icee_tpu_torch.models.factored_lstm.embed`)."""
    return _train_forward(_Family(params, cfg, style, True, vocab), captions,
                          features, teacher_forcing_ratio, generator, train,
                          fused_scan, keep, coins, head_grad=False)


def rnn_att_forward(params: dict, cfg: AttentionDecoderConfig,
                    captions: torch.Tensor, features: torch.Tensor,
                    teacher_forcing_ratio: float = 0.8,
                    generator: Optional[torch.Generator] = None,
                    train: bool = True, fused_scan: bool = False, keep=None,
                    coins: Optional[Sequence[bool]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NIC+Att training forward -> (logits, alphas)
    (``nic/model_att.py:217-281``)."""
    fam = _Family(params, cfg, 0, False)
    return _forward_logits(fam, captions, features, teacher_forcing_ratio,
                           generator, train, fused_scan, keep, coins)


def rnn_att_forward_hiddens(params: dict, cfg: AttentionDecoderConfig,
                            captions: torch.Tensor, features: torch.Tensor,
                            teacher_forcing_ratio: float = 0.8,
                            generator: Optional[torch.Generator] = None,
                            train: bool = True, fused_scan: bool = False,
                            keep=None,
                            coins: Optional[Sequence[bool]] = None,
                            vocab=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NIC+Att training forward -> (hiddens, alphas); see
    :func:`factored_att_forward_hiddens`."""
    return _train_forward(_Family(params, cfg, 0, False, vocab), captions,
                          features, teacher_forcing_ratio, generator, train,
                          fused_scan, keep, coins, head_grad=False)
