"""SentiCap adversarial style variant (port of
``icee_tpu/senticap/adversarial.py``; reference ``mrnn_adv.py``, SURVEY C4;
unused by the reference drivers but part of the family).

Differences from the base mRNN:

- a learned style embedding table ``style (n_styles, style_len)``; the step-0
  visual pseudo-word becomes ``cat([v @ wvm, style[idx]]) + bmv``
  (``mrnn_adv.py:387-396``) with ``wvm`` mapping into ``emb - style_len``,
- adversarial losses (``:506-578``):
  * ``MSQ_LOSS``: a style->image regressor fed through GRADIENT REVERSAL
    (the generator is pushed to make style embeddings UNinformative of the
    image): ``msq = mean_B sum((grad_reverse(style) @ wsty_to_img + b
    - v @ detach(wvm))^2)``, added with ``style_to_image_loss_factor``,
  * ``BATCH_IMAGE_LOSS``: an image->style classifier
    ``softmax(v @ wv_to_sty + b)`` with summed CE against the style index.

``grad_reverse`` / ``grad_ignore`` reproduce the custom Theano ops
(``mrnn_util.py:99-123``) as a ``torch.autograd.Function`` whose backward
is -g, and ``.detach()``.  The JAX twin runs a plain ``lax.scan`` and
reaches no Pallas kernel, so :func:`forward` is this module's own loop
over :func:`icee_tpu_torch.senticap.model.cell` on every device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from icee_tpu_torch.senticap.config import senticap_conf
from icee_tpu_torch.senticap.model import cell, init_params as init_base
from icee_tpu_torch.senticap.model import loss_fn


class GradReverse(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient negated."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def grad_reverse(x: torch.Tensor) -> torch.Tensor:
    return GradReverse.apply(x)


def grad_ignore(x: torch.Tensor) -> torch.Tensor:
    """``mrnn_util.GradIgnore``: the value, no gradient."""
    return x.detach()


def adv_conf(**overrides):
    conf = senticap_conf(
        style_len=64,
        n_styles=2,
        MSQ_LOSS=True,
        BATCH_IMAGE_LOSS=False,
        style_to_image_loss_factor=0.01,
    )
    conf.update(overrides)
    return conf


def init_params(generator: torch.Generator, vocab_size: int, conf,
                dtype=torch.float32, device="cpu") -> dict:
    """The base mRNN's parameters (:func:`~icee_tpu_torch.senticap.model.
    init_params`) with ``wvm`` narrowed to ``(visual, emb - style_len)``
    and the style table, regressor and classifier added, Xavier-uniform
    from ``generator`` (not the JAX package's numbers; parity tests move
    the JAX params across with :mod:`icee_tpu_torch.bridge`)."""
    sl, e, vis = conf["style_len"], conf["emb_size"], conf["visual_size"]
    params = init_base(generator, vocab_size, conf, dtype=dtype,
                       device=device)

    def xav(shape):
        a = math.sqrt(6.0 / sum(shape))
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return (u * (2 * a) - a).to(device)

    # wvm now maps into the non-style slice of the embedding
    params["wvm"] = xav((vis, e - sl))
    params["style"] = xav((conf["n_styles"], sl))
    params["wsty_to_img"] = xav((sl, e - sl))
    params["bsty_to_img"] = torch.zeros((e - sl,), dtype=dtype, device=device)
    params["wv_to_sty"] = xav((vis, conf["n_styles"]))
    params["bv_to_sty"] = torch.zeros((conf["n_styles"],), dtype=dtype,
                                      device=device)
    return params


def visual_style_embedding(params: dict, v: torch.Tensor,
                           style_idx: torch.Tensor) -> torch.Tensor:
    """Step-0 input: [v @ wvm ; style[idx]] + bmv (``mrnn_adv.py:393-396``)."""
    sty = params["style"][style_idx.long()]
    return torch.cat([v @ params["wvm"], sty], dim=-1) + params["bmv"]


def forward(params: dict, conf: dict, words: torch.Tensor, v: torch.Tensor,
            style_idx: torch.Tensor) -> torch.Tensor:
    """Teacher-forced scan -> word distributions (B, T, V)."""
    b, t = words.shape
    emb = params["wemb"][words.long()]
    vis = visual_style_embedding(params, v, style_idx)
    h = torch.zeros((b, conf["lstm_hidden_size"]), dtype=emb.dtype,
                    device=emb.device)
    c = torch.zeros_like(h)
    outs = []
    for step in range(t):
        x_t = vis if step == 0 else emb[:, step]
        h, c = cell(params, x_t, h, c, conf["GRAD_CLIP_SIZE"])
        outs.append(torch.softmax(h @ params["w"] + params["b"], dim=-1))
    return torch.stack(outs, dim=1)


def adversarial_loss(params: dict, conf: dict, v: torch.Tensor,
                     style_idx: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (extra loss term, style-guess accuracy [BATCH_IMAGE_LOSS only])."""
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    idx = style_idx.long()
    if conf.get("MSQ_LOSS"):
        styin = grad_reverse(params["style"][idx])
        v_guess = styin @ params["wsty_to_img"] + params["bsty_to_img"]
        v_real = v @ grad_ignore(params["wvm"])
        msq = torch.sum((v_guess - v_real) ** 2) / v.shape[0]
        return msq * conf["style_to_image_loss_factor"], zero
    if conf.get("BATCH_IMAGE_LOSS"):
        logits = v @ params["wv_to_sty"] + params["bv_to_sty"]
        logp = torch.log_softmax(logits, dim=-1)
        ce = -torch.sum(torch.gather(logp, 1, idx[:, None]))
        acc = torch.mean((torch.argmax(logits, dim=-1) == idx).to(v.dtype))
        return ce, acc
    return zero, zero


def total_loss(params: dict, conf: dict, words: torch.Tensor,
               y: torch.Tensor, mask: torch.Tensor, v: torch.Tensor,
               style_idx: torch.Tensor) -> torch.Tensor:
    """Masked-sum CE + the adversarial term (``mrnn_adv.py:560-578``)."""
    s = forward(params, conf, words, v, style_idx)
    extra, _ = adversarial_loss(params, conf, v, style_idx)
    return loss_fn(s, y, mask) + extra
