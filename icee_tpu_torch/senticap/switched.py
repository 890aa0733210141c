"""SentiCap switched two-LSTM model (port of
``icee_tpu/senticap/switched.py``).

Parity target: ``mrnn_switched.py``, the SentiCap method itself: a
background caption LSTM plus a sentiment LSTM with a duplicated weight set,
mixed per step by a learned switch gate.

Per step (``mrnn_switched.py:780-890``):

- the background path runs the ORIGINAL weights with no dropout,
- the sentiment path runs the ``*_sw`` duplicate weights with dropout,
- switch gate ``att = sigmoid([hh_orig ; hh_new] @ att_w + att_b)`` on the
  cells' outputs before output dropout,
- output mixing by DOMAIN_ADAPT mode; ``DA_SUM``: ``s = s_orig`` when the
  batch sentiment is descriptive (senti <= -0.5), else
  ``(1-att) * s_orig + att * s_new``,
- the scan also emits ``log(att)`` / ``log(1-att)`` traces for the
  switch-supervision loss and test-time highlighting.

Loss (``:1006-1057``, DA_SUM): ``sum(CE*m) + LAMBDA_N * sum(CE*m*(1-sw)) +
sum((1+LAMBDA_N) * LAMBDA_GAM * (sw*(-log att) + (1-sw)*(-log(1-att))) * m)``
with ``sw`` the per-token ANP switch indicator; :func:`cost_fn` adds
``L2_REG_CONST * sum(p^2)`` over the trainable params, and the
``DA_SIMILAR_PARAM*`` modes the orig-vs-sw similarity regularizer.  Switch
training optimizes ONLY ``config.SWITCH_PARAMS``.

Routing: ``forward(return_hiddens=True)`` runs the two recurrences as two
K8 scans (``ops/senticap_scan.py``) when ``conf["FUSED_SCAN"]`` asks for it
(None = on for CUDA tensors): they are independent, the gate mixes their
outputs.  When none of the background weights needs a gradient (switch
training) the background scan runs without autograd, since the gate needs
only its value.  The loss from those hidden states is the chunked mixture
CE (``ops/chunked_loss.py::mixture_ce_from_hiddens``).  The model ignores
BATCH_NORM, as the JAX package's does.

Vocab surgery (``:480-518``): new sentiment words take the embedding and
output rows of their closest existing word (:func:`grow_vocab`, with
:func:`make_embedding_closest_fn` as the data-free closeness measure).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from icee_tpu_torch.senticap.config import (
    DA_FIXED_ALPHA,
    DA_SIMILAR_PARAM,
    DA_SIMILAR_PARAM_2,
    DA_SIMILAR_PARAM_3,
    DA_SUM,
    SWITCH_PARAMS,
    senticap_conf,
)
from icee_tpu_torch.senticap.model import (
    _check_conf,
    _use_fused_scan,
    cell,
    init_params as init_base_params,
    visual_embedding,
)

BASE_NAMES = ("wemb", "w_lstm", "w", "b", "wvm", "bmv")


def init_params(generator: torch.Generator, vocab_size: int, conf=None,
                base: Optional[dict] = None, dtype=torch.float32,
                device="cpu") -> dict:
    """Full parameter set: originals + ``*_sw`` duplicates + gate.

    ``base``: a trained base-model dict whose values seed BOTH paths
    (``mrnn_switched.py:523-548`` copies the pretrained set into the
    duplicates); without it the base set is drawn first.  The gate weight
    is uniform +-sqrt(6 / (2H + 1)), its bias 0; ``wsenti``/``wsenti2`` are
    the reference's dead sentiment projections (``mrnn_switched.py:574-580``,
    their only use commented out at ``:699-700``), created for parity."""
    conf = conf or senticap_conf()
    if base is None:
        base = init_base_params(generator, vocab_size, conf, dtype=dtype,
                                device=device)
    params = {k: v.detach().to(device, copy=True) for k, v in base.items()}
    params.update({f"{k}_sw": v.clone() for k, v in params.items()})
    h = conf["lstm_hidden_size"]

    def uniform(shape, a):
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return (u * (2 * a) - a).to(device)

    params["att_w"] = uniform((2 * h, 1), math.sqrt(6.0 / (2 * h + 1)))
    params["att_b"] = torch.zeros((1,), dtype=dtype, device=device)
    a1 = math.sqrt(6.0 / (h + 1))
    params["wsenti"] = uniform((h, 1), a1)
    params["wsenti2"] = uniform((h, 1), a1)
    return params


def switch_param_mask(params: dict) -> dict:
    """Trainable = the switch set only (``train_joint.py:355-359``)."""
    return {k: (k in SWITCH_PARAMS) for k in params}


def _base_view(params: dict, sw: bool) -> dict:
    suffix = "_sw" if sw else ""
    return {n: params[f"{n}{suffix}"] for n in BASE_NAMES}


def _senti(senti0, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(senti0, device=like.device)


def _gate(params: dict, h_o: torch.Tensor, h_n: torch.Tensor
          ) -> torch.Tensor:
    """``sigmoid([h_o ; h_n] @ att_w + att_b)`` -> (..., 1)."""
    return torch.sigmoid(torch.cat([h_o, h_n], dim=-1) @ params["att_w"]
                         + params["att_b"])


def _mix(conf: dict, s_o: torch.Tensor, s_n: torch.Tensor,
         att: torch.Tensor, senti0) -> torch.Tensor:
    """The DOMAIN_ADAPT mixing of the two heads' distributions."""
    mode = conf["DOMAIN_ADAPT"]
    if mode == DA_SUM or mode == DA_SIMILAR_PARAM_3:
        mixed = (1.0 - att) * s_o + att * s_n
    elif mode == DA_FIXED_ALPHA:
        mixed = (1.0 - conf["FIXED_ALPHA"]) * s_o + conf["FIXED_ALPHA"] * s_n
    elif mode in (DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2):
        mixed = s_n
    else:
        raise ValueError(f"unknown DOMAIN_ADAPT {mode}")
    return torch.where(_senti(senti0, s_o) <= -0.5, s_o, mixed)


def _cells(params: dict, conf: dict, x_o: torch.Tensor, x_n: torch.Tensor,
           h: torch.Tensor, c: torch.Tensor, x_drop=None, y_drop=None):
    """Both cells from their inputs -> (hh_o, cc_o, hh_n, cc_n, head input
    of the sentiment path).  The sentiment path takes the dropouts."""
    hs = conf["lstm_hidden_size"]
    gclip = conf["GRAD_CLIP_SIZE"]
    if conf["DROP_INPUT"] and x_drop is not None:
        x_n = x_n * x_drop
    hh_o, cc_o = cell(_base_view(params, False), x_o, h[..., :hs],
                      c[..., :hs], gclip)
    hh_n, cc_n = cell(_base_view(params, True), x_n, h[..., hs:],
                      c[..., hs:], gclip)
    yy_n = hh_n * y_drop if (conf["DROP_OUTPUT"]
                             and y_drop is not None) else hh_n
    return hh_o, cc_o, hh_n, cc_n, yy_n


def _heads(params: dict, hh_o: torch.Tensor, yy_n: torch.Tensor):
    s_o = torch.softmax(hh_o @ params["w"] + params["b"], dim=-1)
    s_n = torch.softmax(yy_n @ params["w_sw"] + params["b_sw"], dim=-1)
    return s_o, s_n


def step(params: dict, conf: dict, word: torch.Tensor, use_v,
         h: torch.Tensor, c: torch.Tensor, v: torch.Tensor, senti0,
         x_drop: Optional[torch.Tensor] = None,
         y_drop: Optional[torch.Tensor] = None,
         return_hiddens: bool = False):
    """One switched recurrence -> (s_t, h, c, log_att, log_1m_att); with
    ``return_hiddens`` the two softmaxes are skipped and the first element
    is ``(hh_o, head_in_n, att[:, 0])``: the head inputs (the sentiment
    one after output dropout) and the gate, for the chunked mixture loss.
    ``h``, ``c`` (B, 2H) hold the [orig ; new] halves."""
    word = word.long()
    use_v = torch.as_tensor(use_v, device=h.device)[..., None]
    xs = [torch.where(use_v, visual_embedding(view, v),
                      view["wemb"][word])
          for view in (_base_view(params, False), _base_view(params, True))]
    hh_o, cc_o, hh_n, cc_n, yy_n = _cells(params, conf, *xs, h, c, x_drop,
                                          y_drop)
    att = _gate(params, hh_o, hh_n)                            # (B, 1)
    h_out = torch.cat([hh_o, hh_n], dim=1)
    c_out = torch.cat([cc_o, cc_n], dim=1)
    if return_hiddens:
        return ((hh_o, yy_n, att[:, 0]), h_out, c_out, torch.log(att),
                torch.log(1.0 - att))
    s_t = _mix(conf, *_heads(params, hh_o, yy_n), att, senti0)
    return s_t, h_out, c_out, torch.log(att), torch.log(1.0 - att)


def forward(params: dict, conf: dict, words: torch.Tensor, v: torch.Tensor,
            senti0, x_drop: Optional[torch.Tensor] = None,
            y_drop: Optional[torch.Tensor] = None, use_visual: bool = True,
            return_hiddens: bool = False):
    """Teacher-forced scan -> (s (B, T, V), log_att (B, T), log_1m_att (B,
    T)); with ``return_hiddens`` the first element is instead ``(hh_o (B,
    T, H), hh_n (B, T, H), att (B, T))``: the head inputs (the sentiment
    one after output dropout) and the switch gates, for the chunked mixture
    loss (the (B, T, V) distributions never exist).  ``JOINED_LOSS_FUNCTION``
    is refused, as by the base model."""
    _check_conf(conf)
    b, t = words.shape
    hs = conf["lstm_hidden_size"]
    dev = v.device
    if x_drop is None:
        x_drop = torch.ones((b, t, conf["emb_size"]), device=dev)
    if y_drop is None:
        y_drop = torch.ones((b, t, hs), device=dev)
    words = words.long()

    if return_hiddens and _use_fused_scan(conf, dev, False):
        from icee_tpu_torch.ops.senticap_scan import fused_senticap_scan

        gclip = conf["GRAD_CLIP_SIZE"]

        def path(sw_path, drop):
            view = _base_view(params, sw_path)
            x_full = view["wemb"][words]
            if use_visual:
                x_full = torch.cat([visual_embedding(view, v)[:, None, :],
                                    x_full[:, 1:]], dim=1)
            if conf["DROP_INPUT"] and drop is not None:
                x_full = x_full * drop
            return fused_senticap_scan(view["w_lstm"], x_full.contiguous(),
                                       gclip)

        frozen = not any(params[k].requires_grad for k in BASE_NAMES)
        with torch.set_grad_enabled(torch.is_grad_enabled() and not frozen):
            h_o = path(False, None)                              # (B, T, H)
        h_n = path(True, x_drop)
        att = _gate(params, h_o, h_n)[..., 0]                    # (B, T)
        hh_n = h_n * y_drop if conf["DROP_OUTPUT"] else h_n
        return (h_o, hh_n, att), torch.log(att), torch.log(1.0 - att)

    h = torch.zeros((b, 2 * hs), device=dev)
    c = torch.zeros((b, 2 * hs), device=dev)
    outs, las, l1as = [], [], []
    for i in range(t):
        use_v = bool(use_visual and i == 0)
        s_t, h, c, la, l1a = step(params, conf, words[:, i], use_v, h, c, v,
                                  senti0, x_drop[:, i], y_drop[:, i],
                                  return_hiddens)
        outs.append(s_t)
        las.append(la[:, 0])
        l1as.append(l1a[:, 0])
    la, l1a = torch.stack(las, 1), torch.stack(l1as, 1)
    if return_hiddens:
        hh_o, hh_n, att = (torch.stack(parts, 1) for parts in zip(*outs))
        return (hh_o, hh_n, att), la, l1a
    return torch.stack(outs, 1), la, l1a


def loss_fn(conf: dict, s: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
            sw: torch.Tensor, log_att: torch.Tensor, log_1m_att: torch.Tensor
            ) -> torch.Tensor:
    """Switched loss (``mrnn_switched.py:1006-1057``) from the mixed
    distributions ``s`` (B, T, V)."""
    p = torch.gather(s, -1, y.long()[..., None])[..., 0]
    ce = -torch.log(torch.clamp(p, min=1e-37)) * mask
    base = torch.sum(ce)
    mode = conf["DOMAIN_ADAPT"]
    if mode in (DA_FIXED_ALPHA, DA_SIMILAR_PARAM):
        return base
    neg = conf["LAMBDA_N"] * torch.sum(ce * (1.0 - sw))
    if mode == DA_SIMILAR_PARAM_2:
        return base + neg
    gate = torch.sum(
        (1.0 + conf["LAMBDA_N"]) * conf["LAMBDA_GAM"]
        * (sw * (-log_att) + (1.0 - sw) * (-log_1m_att)) * mask)
    return base + neg + gate


def mixture_coefficients(conf: dict, att: torch.Tensor, senti0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token coefficients (co, cn) such that the switched output's
    target probability is ``co * p_orig + cn * p_new``: :func:`step`'s
    mixing rules in coefficient form, for the chunked losses."""
    mode = conf["DOMAIN_ADAPT"]
    if mode in (DA_SUM, DA_SIMILAR_PARAM_3):
        co_m, cn_m = 1.0 - att, att
    elif mode == DA_FIXED_ALPHA:
        alpha = torch.full_like(att, conf["FIXED_ALPHA"])
        co_m, cn_m = 1.0 - alpha, alpha
    elif mode in (DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2):
        co_m, cn_m = torch.zeros_like(att), torch.ones_like(att)
    else:
        raise ValueError(f"unknown DOMAIN_ADAPT {mode}")
    descriptive = _senti(senti0, att) <= -0.5
    return (torch.where(descriptive, 1.0, co_m),
            torch.where(descriptive, 0.0, cn_m))


def loss_fn_from_hiddens(params: dict, conf: dict, hh_o: torch.Tensor,
                         hh_n: torch.Tensor, att: torch.Tensor, senti0,
                         y: torch.Tensor, mask: torch.Tensor,
                         sw: torch.Tensor, log_att: torch.Tensor,
                         log_1m_att: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn` from the hidden states: the two (B, T, V)
    distributions never exist (``ops/chunked_loss.py``).  The ``base +
    LAMBDA_N * (1-sw)`` CE pair folds into one weighted chunked pass; the
    V-free gate term is unchanged."""
    from icee_tpu_torch.ops.chunked_loss import mixture_ce_from_hiddens

    mode = conf["DOMAIN_ADAPT"]
    co, cn = mixture_coefficients(conf, att, senti0)
    m = mask.to(torch.float32)
    if mode in (DA_FIXED_ALPHA, DA_SIMILAR_PARAM):
        weights = m                                      # base term only
    else:
        weights = m * (1.0 + conf["LAMBDA_N"] * (1.0 - sw))
    ce = mixture_ce_from_hiddens(hh_o, hh_n, co, cn, params["w"],
                                 params["b"], params["w_sw"], params["b_sw"],
                                 y, weights)
    if mode in (DA_FIXED_ALPHA, DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2):
        return ce
    gate = torch.sum(
        (1.0 + conf["LAMBDA_N"]) * conf["LAMBDA_GAM"]
        * (sw * (-log_att) + (1.0 - sw) * (-log_1m_att)) * m)
    return ce + gate


def cost_fn(params: dict, conf: dict, loss: torch.Tensor,
            trainable_mask: Optional[dict] = None) -> torch.Tensor:
    """loss + L2 over trainable params (+ the similarity regularizer for
    DA_SIMILAR_*) (``mrnn_switched.py:1098-1111``)."""
    mask = trainable_mask or {k: True for k in params}
    l2 = sum(torch.sum(p ** 2) for k, p in params.items() if mask.get(k))
    cost = loss + conf["L2_REG_CONST"] * l2
    if conf["DOMAIN_ADAPT"] in (DA_SIMILAR_PARAM, DA_SIMILAR_PARAM_2,
                                DA_SIMILAR_PARAM_3):
        sim = (torch.sum((params["w"] - params["w_sw"]) ** 2)
               + torch.sum((params["b"] - params["b_sw"]) ** 2)
               + torch.sum((params["w_lstm"] - params["w_lstm_sw"]) ** 2)
               + torch.sum((params["wvm_sw"] - params["wvm"]) ** 2)
               + torch.sum((params["bmv_sw"] - params["bmv"]) ** 2))
        cost = cost + conf["SIMILAR_PARAM_REG"] * sim
    return cost


def one_step(params: dict, conf: dict, word: torch.Tensor, use_v,
             h: torch.Tensor, c: torch.Tensor, v: torch.Tensor, senti0):
    """Inference step for beam search -> (s_t, h, c, att (B, 1))."""
    s_t, h, c, la, _ = step(params, conf, word, use_v, h, c, v, senti0)
    return s_t, h, c, torch.exp(la)


def beam_step(params: dict, conf: dict, senti0):
    """``step(words (N, B), use_v, h (N, B, 2H), c (N, B, 2H), v (N,
    visual)) -> (s_t (N, B, V), h, c, att (N, B, 1))``, the step
    ``beam.make_device_beam(with_attention=True)`` drives: :func:`one_step`
    over N images of B beams each, with the visual pseudo-words computed
    once per image rather than once per beam row."""

    def run(words, use_v, h, c, v):
        n, b = words.shape
        s = h.shape[-1]
        xs = []
        for view in (_base_view(params, False), _base_view(params, True)):
            if use_v:
                x = visual_embedding(view, v)[:, None, :]
                x = x.expand(n, b, x.shape[-1]).reshape(n * b, -1)
            else:
                x = view["wemb"][words.reshape(-1).long()]
            xs.append(x)
        hh_o, cc_o, hh_n, cc_n, yy_n = _cells(
            params, conf, *xs, h.reshape(n * b, s), c.reshape(n * b, s))
        att = _gate(params, hh_o, hh_n)
        probs = _mix(conf, *_heads(params, hh_o, yy_n), att, senti0)
        h2 = torch.cat([hh_o, hh_n], dim=1)
        c2 = torch.cat([cc_o, cc_n], dim=1)
        return (probs.reshape(n, b, -1), h2.reshape(n, b, s),
                c2.reshape(n, b, s),
                torch.exp(torch.log(att)).reshape(n, b, 1))

    return run


def make_embedding_closest_fn(
    base_wemb,
    base_w2i: Dict[str, int],
    token_lists,                      # iterable of token lists (the new
                                      # sentiment corpus the words come from)
    window: int = 4,
    exclude: Tuple[str, ...] = ("#START#", "#STOP#"),
) -> Callable[[str], int]:
    """Data-free realization of the reference's ``ClosestWordFinder``
    (``mrnn_switched.py:31-73``): map a new sentiment word to its closest
    EXISTING base-vocab word.

    The reference measures closeness with spacy word vectors, external
    data unavailable offline.  Here a new word's distributional vector is
    the mean of the base ``wemb`` rows of its in-vocab context words
    (within ``window`` tokens across the sentiment corpus), and the closest
    word is the cosine-nearest base ``wemb`` row.  In-vocab words map to
    their own index (``mrnn_switched.py:47-49``); words with no usable
    context fall back to the most frequent in-corpus base word."""
    if isinstance(base_wemb, torch.Tensor):
        base_wemb = base_wemb.detach().cpu().numpy()
    wemb = np.asarray(base_wemb, np.float64)
    n_base = wemb.shape[0]
    norms = np.linalg.norm(wemb, axis=1) + 1e-12
    unit = wemb / norms[:, None]
    excluded_ids = {base_w2i[w] for w in exclude if w in base_w2i}

    # context accumulation over the corpus (host-side, one pass)
    ctx_sum: Dict[str, np.ndarray] = {}
    ctx_cnt: Dict[str, int] = {}
    base_freq: Dict[int, int] = {}
    for toks in [list(toks) for toks in token_lists]:
        ids = [base_w2i.get(t, -1) for t in toks]
        for j, t in enumerate(toks):
            if ids[j] >= 0:
                base_freq[ids[j]] = base_freq.get(ids[j], 0) + 1
                continue
            lo, hi = max(0, j - window), min(len(toks), j + window + 1)
            for k2 in range(lo, hi):
                if k2 == j or ids[k2] < 0 or ids[k2] in excluded_ids:
                    continue
                if t not in ctx_sum:
                    ctx_sum[t] = np.zeros(wemb.shape[1])
                    ctx_cnt[t] = 0
                ctx_sum[t] += wemb[ids[k2]]
                ctx_cnt[t] += 1
    freq_fallback = max(
        (i for i in base_freq if i not in excluded_ids),
        key=lambda i: (base_freq[i], -i), default=min(1, n_base - 1))

    def closest(word: str) -> int:
        if word in base_w2i:
            return base_w2i[word]
        if word not in ctx_sum or ctx_cnt[word] == 0:
            return freq_fallback
        q = ctx_sum[word] / ctx_cnt[word]
        qn = np.linalg.norm(q)
        if qn < 1e-12:
            return freq_fallback
        sims = unit @ (q / qn)
        for i in excluded_ids:
            sims[i] = -np.inf
        return int(np.argmax(sims))

    return closest


def grow_vocab(params: dict, added_words,
               closest_fn: Callable[[str], int]) -> dict:
    """Vocab surgery (``mrnn_switched.py:480-518``): extend the ``wemb``
    rows, ``w`` columns and ``b`` entries of both paths by copying the
    closest existing word's parameters.  ``added_words``: ``[(word,
    new_index), ...]``.  Returns a new dict (the input is unchanged)."""
    out = dict(params)
    max_idx = max(i for _, i in added_words)
    for suffix in ("", "_sw"):
        wemb, w, b = (out[f"{n}{suffix}"] for n in ("wemb", "w", "b"))
        n_new = max_idx - wemb.shape[0] + 1
        if n_new > 0:
            wemb = torch.cat([wemb, wemb.new_zeros((n_new, wemb.shape[1]))])
            w = torch.cat([w, w.new_zeros((w.shape[0], n_new))], dim=1)
            b = torch.cat([b, b.new_zeros((n_new,))])
        else:
            wemb, w, b = wemb.clone(), w.clone(), b.clone()
        for word, i in added_words:
            ci = closest_fn(word)
            wemb[i, :] = wemb[ci, :]
            w[:, i] = w[:, ci]
            b[i] = b[ci]
        out[f"wemb{suffix}"], out[f"w{suffix}"], out[f"b{suffix}"] = wemb, w, b
    return out
