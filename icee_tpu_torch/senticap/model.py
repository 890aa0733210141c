"""Base multimodal RNN (mRNN) language/caption model (port of
``icee_tpu/senticap/model.py``).

Parity target: the Theano ``RNNModel`` (``senticap/mrnn/mrnn.py``).  Numerics
kept exactly:

- one fused recurrent product ``[x_t ; clip(h)] @ w_lstm`` split into [i, f,
  o, cell] gate slices (``mrnn.py:416-433``) with ``hh = og * cc``, NO tanh
  on the cell (``:433``);
- the image injected as the step-0 pseudo-word ``v @ wvm + bmv``
  (``:390-391``); words shift in from step 1;
- ``clipg`` (``mrnn_util.py:78-98``) clips the *backward* signal of ``h`` to
  +/-GRAD_CLIP_SIZE, forward is the identity (:class:`GradClip`);
- loss = SUM of per-token categorical cross-entropy weighted by the mask
  (``mrnn.py:544-567``), NOT a mean;
- perplexity ``2 ** (sum(-log2 p) / sum(len))`` with the +1e-20 fudge
  (``:518-530``);
- output bias initialized to the log unigram distribution (``:347-362``);
- dropout via precomputed masks on input embeddings and hidden output.

Routing: ``forward(return_hiddens=True)`` sends the teacher-forced scan to
K8 (``ops/senticap_scan.py``) when ``conf["FUSED_SCAN"]`` asks for it (None
= on for CUDA tensors), for any batch size.  The BATCH_NORM branch and
:func:`forward_semi_forced` stay on this module's own scan on every device:
the JAX package has no kernel for them either, so that is the model's
branch, not a wrapper fallback.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from icee_tpu_torch.senticap.config import senticap_conf


# --- grad-clip-on-activation op (mrnn_util.py GradClip) -------------------

class GradClip(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient clamped to +-bound."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.bound = float(bound)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-ctx.bound, ctx.bound), None


def grad_clip_act(x: torch.Tensor, bound: float) -> torch.Tensor:
    return GradClip.apply(x, bound)


def _requested(conf: dict, key: str, device: torch.device) -> bool:
    knob = conf.get(key)
    if knob is None:
        return torch.device(device).type == "cuda"
    return bool(knob)


def fused_scan_requested(conf: dict, device) -> bool:
    """``conf["FUSED_SCAN"]``: None = on for CUDA tensors."""
    return _requested(conf, "FUSED_SCAN", device)


def chunked_ce_requested(conf: dict, device) -> bool:
    """``conf["CHUNKED_CE"]``: None = on for CUDA tensors (callers also
    require ``SOFTMAX_OUT``)."""
    return _requested(conf, "CHUNKED_CE", device)


def _use_fused_scan(conf: dict, device, batch_norm: bool) -> bool:
    """The teacher-forced scan goes to K8 unless BATCH_NORM is on (the
    affine quirk has no kernel); K8 takes any batch size."""
    return fused_scan_requested(conf, device) and not batch_norm


# --- parameters -----------------------------------------------------------

def init_params(generator: torch.Generator, vocab_size: int, conf=None,
                unigram: Optional[np.ndarray] = None, dtype=torch.float32,
                device="cpu") -> dict:
    """Xavier-style init matching ``mrnn_util.py:46-70`` (uniform
    +/- sqrt(6/(fan_in+fan_out))); output bias = log unigram probs.  Draws
    from ``generator`` (not the JAX package's numbers; parity tests move
    the JAX params across with :mod:`icee_tpu_torch.bridge`)."""
    conf = conf or senticap_conf()
    e, h, v = conf["emb_size"], conf["lstm_hidden_size"], vocab_size
    vis = conf["visual_size"]

    def xav(shape):
        a = math.sqrt(6.0 / (shape[0] + shape[1]))
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return (u * (2 * a) - a).to(device)

    if unigram is not None:
        b = torch.as_tensor(np.log(unigram + 1e-20), dtype=dtype,
                            device=device)
    else:
        b = torch.full((v,), -math.log(v), dtype=dtype, device=device)
    params = {
        "wemb": xav((v, e)),
        "w_lstm": xav((e + h, 4 * h)),
        "w": xav((h, v)),
        "b": b,
        "wvm": xav((vis, e)),
        "bmv": torch.zeros((e,), dtype=dtype, device=device),
    }
    if conf.get("BATCH_NORM"):
        # gamma/beta over the [x_t ; h] input state (mrnn.py:293-300)
        params["gamma_h"] = torch.ones((e + h,), dtype=dtype, device=device)
        params["beta_h"] = torch.zeros((e + h,), dtype=dtype, device=device)
    return params


# --- cell -----------------------------------------------------------------

def cell(params: dict, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
         grad_clip: float = 5.0, batch_norm: bool = False
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence (``mrnn.py:404-440``): fused [x;h] product, gate order
    [i, f, o, cellcand], ``hh = og * cc``.

    ``batch_norm`` reproduces the reference's BATCH_NORM QUIRK
    (``mrnn.py:408-413``): it applies ``gamma_h * in_state + beta_h`` to the
    UN-normalized state (the normalization is dead code there)."""
    hs = h.shape[-1]
    in_state = torch.cat([x_t, grad_clip_act(h, grad_clip)], dim=-1)
    if batch_norm:
        in_state = params["gamma_h"] * in_state + params["beta_h"]
    z = in_state @ params["w_lstm"]
    ig = torch.sigmoid(z[:, :hs])
    fg = torch.sigmoid(z[:, hs:2 * hs])
    og = torch.sigmoid(z[:, 2 * hs:3 * hs])
    cc = fg * c + ig * torch.tanh(z[:, 3 * hs:])
    hh = og * cc  # reference quirk: no tanh (mrnn.py:433)
    return hh, cc


def output_probs(params: dict, hh: torch.Tensor,
                 softmax_out: bool = True) -> torch.Tensor:
    """Word distribution (``mrnn.py:438-443``): softmax, or the joined
    model's elementwise sigmoid with ``SOFTMAX_OUT=False``."""
    logits = hh @ params["w"] + params["b"]
    if softmax_out:
        return torch.softmax(logits, dim=-1)
    return torch.sigmoid(logits)


def visual_embedding(params: dict, v: torch.Tensor) -> torch.Tensor:
    """Image as pseudo-word: ``v @ wvm + bmv`` (``mrnn.py:390-391``)."""
    return v @ params["wvm"] + params["bmv"]


def _check_conf(conf: dict) -> None:
    """``JOINED_LOSS_FUNCTION`` (``mrnn.py:111-115``) is refused, here as in
    the JAX package: an error, not a no-op.  Neither package has a joined
    loss; the switched model's loss is ``senticap/switched.py::loss_fn``."""
    if conf.get("JOINED_LOSS_FUNCTION"):
        raise NotImplementedError(
            "JOINED_LOSS_FUNCTION is not supported: the switched model's "
            "loss is senticap/switched.py::loss_fn")


def _masks(b, t, conf, x_drop, y_drop, like):
    if x_drop is None:
        x_drop = torch.ones((b, t, conf["emb_size"]), dtype=like.dtype,
                            device=like.device)
    if y_drop is None:
        y_drop = torch.ones((b, t, conf["lstm_hidden_size"]),
                            dtype=like.dtype, device=like.device)
    return x_drop, y_drop


# --- forward scans --------------------------------------------------------

def forward(params: dict, conf: dict, words: torch.Tensor, v: torch.Tensor,
            use_visual: bool = True, x_drop: Optional[torch.Tensor] = None,
            y_drop: Optional[torch.Tensor] = None,
            return_hiddens: bool = False) -> torch.Tensor:
    """Teacher-forced scan -> word distributions (B, T, V), or with
    ``return_hiddens`` the post-output-dropout hidden states (B, T, H) for
    the chunked loss.

    Step 0 consumes the visual pseudo-word when ``use_visual``; step t >= 1
    consumes ``words[:, t]`` (START, w1, ...).  With ``return_hiddens`` and
    the fused scan requested (and no BATCH_NORM) the recurrence runs K8."""
    _check_conf(conf)
    b, t = words.shape
    gclip = conf["GRAD_CLIP_SIZE"]
    bn = conf.get("BATCH_NORM", False)
    emb = params["wemb"][words.long()]                       # (B, T, E)
    vis = visual_embedding(params, v)                        # (B, E)
    x_drop, y_drop = _masks(b, t, conf, x_drop, y_drop, emb)

    if return_hiddens and _use_fused_scan(conf, emb.device, bn):
        from icee_tpu_torch.ops.senticap_scan import fused_senticap_scan

        x_full = emb
        if use_visual:
            x_full = torch.cat([vis[:, None, :], emb[:, 1:]], dim=1)
        if conf["DROP_INPUT"]:
            x_full = x_full * x_drop
        h_seq = fused_senticap_scan(params["w_lstm"], x_full.contiguous(),
                                    gclip)
        return h_seq * y_drop if conf["DROP_OUTPUT"] else h_seq

    h = torch.zeros((b, conf["lstm_hidden_size"]), dtype=emb.dtype,
                    device=emb.device)
    c = torch.zeros_like(h)
    outs = []
    for step in range(t):
        x_t = vis if (use_visual and step == 0) else emb[:, step]
        if conf["DROP_INPUT"]:
            x_t = x_t * x_drop[:, step]
        h, c = cell(params, x_t, h, c, gclip, bn)
        hh = h * y_drop[:, step] if conf["DROP_OUTPUT"] else h
        outs.append(hh if return_hiddens else
                    output_probs(params, hh, conf.get("SOFTMAX_OUT", True)))
    return torch.stack(outs, dim=1)


def forward_semi_forced(params: dict, conf: dict, words: torch.Tensor,
                        v: torch.Tensor, forced: torch.Tensor,
                        x_drop: Optional[torch.Tensor] = None,
                        y_drop: Optional[torch.Tensor] = None,
                        return_hiddens: bool = False) -> torch.Tensor:
    """Semi-forced scan (``recurrance_partial_word_feedback``,
    ``mrnn.py:442-476,496-503``): per (sample, step) the input is the teacher
    token where ``forced`` > 0, else the model's own previous argmax.  Runs
    this module's scan on every device (no kernel, as in the JAX package)."""
    _check_conf(conf)
    b, t = words.shape
    gclip = conf["GRAD_CLIP_SIZE"]
    bn = conf.get("BATCH_NORM", False)
    vis = visual_embedding(params, v)
    x_drop, y_drop = _masks(b, t, conf, x_drop, y_drop, vis)
    h = torch.zeros((b, conf["lstm_hidden_size"]), dtype=vis.dtype,
                    device=vis.device)
    c = torch.zeros_like(h)
    prev = torch.zeros((b,), dtype=torch.long, device=vis.device)
    words = words.long()
    outs = []
    for step in range(t):
        tok = torch.where(forced[:, step] > 0, words[:, step], prev)
        x_t = vis if step == 0 else params["wemb"][tok]
        if conf["DROP_INPUT"]:
            x_t = x_t * x_drop[:, step]
        h, c = cell(params, x_t, h, c, gclip, bn)
        hh = h * y_drop[:, step] if conf["DROP_OUTPUT"] else h
        if return_hiddens:
            # argmax feedback from transient logits (no gradient)
            logits = hh.detach() @ params["w"] + params["b"]
            prev = torch.argmax(logits, dim=-1)
            outs.append(hh)
        else:
            s_t = output_probs(params, hh, conf.get("SOFTMAX_OUT", True))
            prev = torch.argmax(s_t, dim=-1)
            outs.append(s_t)
    return torch.stack(outs, dim=1)


def loss_fn(s: torch.Tensor, y: torch.Tensor, mask: torch.Tensor
            ) -> torch.Tensor:
    """SUM of masked categorical cross-entropy (``mrnn.py:560-567``).
    ``s``: (B, T, V) probabilities, ``y``: (B, T) targets, ``mask``: (B, T)."""
    p = torch.gather(s, -1, y.long()[..., None])[..., 0]
    nll = -torch.log(torch.clamp(p, min=1e-37))
    return torch.sum(nll * mask)


# -log of the reference's probability floor (mrnn.py:563): the chunked loss
# realizes -log(max(p, 1e-37)) as min(lse - tgt_logit, CLAMP), with zero
# gradient where clamped, exactly like the materialized max
PROB_FLOOR_CLAMP = 85.19956545910916  # == -log(1e-37)


def loss_fn_from_hiddens(params: dict, hh: torch.Tensor, y: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn` from the (post-dropout) hidden states in time chunks
    (``ops/chunked_loss.py``): the (B, T, V) distributions never exist.
    Only for ``SOFTMAX_OUT`` models."""
    from icee_tpu_torch.ops.chunked_loss import masked_sum_ce_from_hiddens

    return masked_sum_ce_from_hiddens(hh, params["w"], params["b"], y, mask,
                                      clamp=PROB_FLOOR_CLAMP)


def perplexity(s: torch.Tensor, y: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
    """``2 ** (sum(-log2 p) / sum(len))`` with the 1e-20 fudge
    (``mrnn.py:518-530``)."""
    p = torch.gather(s, -1, y.long()[..., None])[..., 0]
    hsum = -torch.log2(p + 1e-20)
    return 2.0 ** (torch.sum(hsum * mask) / torch.sum(mask))


def one_step(params: dict, conf: dict, word: torch.Tensor,
             use_v: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
             v: torch.Tensor):
    """Single decode step (``mrnn.py:532-546``) -> (s_t (B, V), h, c)."""
    emb = params["wemb"][word.long()]
    use_v = torch.as_tensor(use_v, device=emb.device)
    x_t = torch.where(use_v[..., None], visual_embedding(params, v), emb)
    h, c = cell(params, x_t, h, c, conf["GRAD_CLIP_SIZE"],
                conf.get("BATCH_NORM", False))
    return output_probs(params, h, conf.get("SOFTMAX_OUT", True)), h, c


def beam_step(params: dict, conf: dict):
    """``step(words (N, B), use_v, h (N, B, S), c (N, B, S), v (N, visual))
    -> (s_t (N, B, V), h, c)``, the step ``beam.make_device_beam`` drives:
    :func:`one_step` over N images of B beams each, with the visual
    pseudo-word computed once per image rather than once per beam row."""

    def step(words, use_v, h, c, v):
        n, b = words.shape
        s = h.shape[-1]
        if use_v:
            x = visual_embedding(params, v)[:, None, :]
            x = x.expand(n, b, x.shape[-1]).reshape(n * b, -1)
        else:
            x = params["wemb"][words.reshape(-1).long()]
        h2, c2 = cell(params, x, h.reshape(n * b, s), c.reshape(n * b, s),
                      conf["GRAD_CLIP_SIZE"], conf.get("BATCH_NORM", False))
        probs = output_probs(params, h2, conf.get("SOFTMAX_OUT", True))
        return (probs.reshape(n, b, -1), h2.reshape(n, b, s),
                c2.reshape(n, b, s))

    return step


def greedy_sample(params: dict, conf: dict, v: torch.Tensor,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Free-running argmax rollout (``sample_sentence``,
    ``mrnn.py:837-871``) -> (B, max_len) int64 tokens."""
    max_len = max_len or conf["MAX_SENTENCE_LEN"] + 1
    b = v.shape[0]
    h = torch.zeros((b, conf["lstm_hidden_size"]), dtype=v.dtype,
                    device=v.device)
    c = torch.zeros_like(h)
    word = torch.zeros((b,), dtype=torch.long, device=v.device)
    toks = []
    for i in range(max_len):
        s_t, h, c = one_step(params, conf, word,
                             torch.tensor(i == 0, device=v.device), h, c, v)
        word = torch.argmax(s_t, dim=-1)
        toks.append(word)
    return torch.stack(toks, dim=1)
