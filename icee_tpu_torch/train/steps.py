"""Training and validation steps of the global-feature captioners, StyleNet
(factored decoder) and NIC (port of
``icee_tpu/train/steps.py::make_caption_steps``).

One step: encoder head on cached pooled features (BatchNorm in training
mode), the decoder's training forward, the masked token-mean CE, the
gradient, then clamp + Adam.  Targets are the un-shifted caption at step t
(the feature is the step-0 input, ``train_multitask.py:375-383``),
normalized by the valid-token count like the packed ``CrossEntropyLoss``.

On CUDA (``fused_scan`` / ``chunked_ce`` left None) the teacher-forced
decoder runs the K3 kernels (``ops/lstm_scan.py``) for StyleNet or the K4
kernels (``ops/nic_scan.py``) for NIC, and the loss the chunked CE kernels
(``ops/chunked_loss.py``); setting either False runs the plain PyTorch form
on the same device.  NIC has no style weights: its steps ignore ``style``,
and the emotion track trains the whole decoder, as in the JAX package.

Unlike the JAX steps, these update the parameter tensors IN PLACE (and the
head's BatchNorm running statistics) and also return them.  Randomness
comes from a ``torch.Generator``; ``keep`` and ``coins`` may be passed in
instead (see ``models/factored_lstm.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from icee_tpu_torch.core.config import DecoderConfig, TrainConfig
from icee_tpu_torch.core.device import resolve_device
from icee_tpu_torch.evaluation.metrics import (masked_cross_entropy,
                                               masked_top_k_accuracy)
from icee_tpu_torch.models import encoder as enc_mod
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.ops.chunked_loss import masked_ce_from_hiddens
from icee_tpu_torch.train.optim import Adam, AdamState, tree_leaves

_STATE_KEYS = ("running_mean", "running_var")


def _track(tree):
    """Detached copies of a parameter tree that require grad (BatchNorm
    running statistics stay plain: they are state, not parameters)."""
    if isinstance(tree, dict):
        return {k: (v.detach() if k in _STATE_KEYS else _track(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_track(v) for v in tree)
    return tree.detach().requires_grad_(True)


def _grads_like(tree, loss):
    """d loss / d every tracked leaf, as a tree of the same structure (None
    where a leaf is untracked or unused)."""
    leaves = [x for x in tree_leaves(tree) if x.requires_grad]
    got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v) for v in t)
        return next(got) if t.requires_grad else None

    return rebuild(tree)


@torch.no_grad()
def _merge_bn_stats(head: dict, forward_head: dict) -> None:
    """Keep the optimizer-updated weights but the forward pass's BatchNorm
    running statistics (in place)."""
    for k in _STATE_KEYS:
        head["bn"][k].copy_(forward_head["bn"][k])


class CaptionSteps:
    """The three steps of :func:`make_caption_steps`; unpacks as
    ``factual_train_step, emotion_train_step, val_step``.  ``factual_grads``
    and ``emotion_grads`` give a step's loss and pre-optimizer gradients."""

    def __init__(self, cfg: DecoderConfig, tcfg: TrainConfig,
                 optimizer: Adam, lang_optimizer: Adam,
                 device: torch.device, factored: bool = True):
        self.cfg, self.tcfg, self.device = cfg, tcfg, device
        self.factored = factored
        self.optimizer, self.lang_optimizer = optimizer, lang_optimizer
        on_card = device.type == "cuda"
        self.use_fused = on_card if tcfg.fused_scan is None else tcfg.fused_scan
        self.use_chunked = (on_card if tcfg.chunked_ce is None
                            else tcfg.chunked_ce)

    def __iter__(self):
        return iter((self.factual_train_step, self.emotion_train_step,
                     self.val_step))

    def _check_device(self, *trees) -> None:
        for x in (leaf for t in trees for leaf in tree_leaves(t)):
            if x is not None and x.device != self.device:
                raise ValueError(f"step built for {self.device} was given "
                                 f"a tensor on {x.device}")

    def _forward(self, d, captions, feats, style, hiddens=False, **kw):
        """The decoder's training forward -> logits, or hidden states with
        ``hiddens``; NIC ignores ``style``."""
        if self.factored:
            fn = fl.forward_hiddens if hiddens else fl.forward
            return fn(d, self.cfg, captions, feats, style, **kw)
        fn = nic.forward_hiddens if hiddens else nic.forward
        return fn(d, self.cfg, captions, feats, **kw)

    def _head(self, d):
        return ((d["C_w"], d["C_b"]) if self.factored
                else (d["linear_w"], d["linear_b"]))

    def _train_loss(self, d, h, pooled, captions, lengths, sample_mask,
                    style, generator, keep, coins):
        """Masked token-mean CE of the training forward -> (loss, head
        with the forward's BatchNorm running statistics)."""
        feats, new_head = enc_mod.encode_global_from_pooled(h, pooled,
                                                            train=True)
        kw = dict(teacher_forcing_ratio=self.tcfg.teacher_forcing_ratio,
                  generator=generator, train=True, fused_scan=self.use_fused,
                  keep=keep, coins=coins)
        if not self.use_chunked:
            logits = self._forward(d, captions, feats, style, **kw)
            return masked_cross_entropy(logits, captions, lengths,
                                        sample_mask), new_head
        hiddens = self._forward(d, captions, feats, style, hiddens=True,
                                **kw)
        return masked_ce_from_hiddens(hiddens, *self._head(d), captions,
                                      lengths, sample_mask), new_head

    def factual_grads(self, dec, head, pooled, captions, lengths,
                      sample_mask, generator=None, keep=None, coins=None):
        """-> (loss, (decoder grads, head grads), forward head)."""
        self._check_device(dec, head, pooled, captions, lengths, sample_mask)
        with torch.enable_grad():
            d, h = _track(dec), _track(head)
            loss, new_head = self._train_loss(d, h, pooled, captions,
                                              lengths, sample_mask, 0,
                                              generator, keep, coins)
            grads = _grads_like((d, h), loss)
        return loss.detach(), grads, new_head

    def emotion_grads(self, dec, head, pooled, captions, lengths,
                      sample_mask, style, generator=None, keep=None,
                      coins=None):
        """-> (loss, decoder grads, forward head)."""
        self._check_device(dec, head, pooled, captions, lengths, sample_mask)
        with torch.enable_grad():
            d = _track(dec)
            loss, new_head = self._train_loss(d, head, pooled, captions,
                                              lengths, sample_mask,
                                              int(style), generator, keep,
                                              coins)
            grads = _grads_like(d, loss)
        return loss.detach(), grads, new_head

    def factual_train_step(self, dec, head, opt_state: AdamState, pooled,
                           captions, lengths, sample_mask, generator=None,
                           keep=None, coins=None):
        """Factual track: the optimizer covers (decoder, head).  -> (dec,
        head, opt_state, loss), the trees updated in place."""
        loss, grads, new_head = self.factual_grads(
            dec, head, pooled, captions, lengths, sample_mask, generator,
            keep, coins)
        self.optimizer.update(grads, opt_state, (dec, head))
        _merge_bn_stats(head, new_head)
        return dec, head, opt_state, loss

    def emotion_train_step(self, dec, head, opt_state: AdamState, pooled,
                           captions, lengths, sample_mask, style,
                           generator=None, keep=None, coins=None):
        """Emotion (language) track: the optimizer covers the decoder only;
        the head keeps the forward's BatchNorm running statistics."""
        loss, grads, new_head = self.emotion_grads(
            dec, head, pooled, captions, lengths, sample_mask, style,
            generator, keep, coins)
        self.lang_optimizer.update(grads, opt_state, dec)
        _merge_bn_stats(head, new_head)
        return dec, head, opt_state, loss

    @torch.no_grad()
    def val_step(self, dec, head, pooled, captions, lengths, sample_mask,
                 style) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Free-running (ratio 0) forward, head in eval mode
        (``train_multitask.py:272-299``) -> (loss, top-5 %, argmax preds)."""
        self._check_device(dec, head, pooled, captions, lengths, sample_mask)
        feats = enc_mod.encode_global_from_pooled(head, pooled)
        logits = self._forward(dec, captions, feats, int(style),
                               teacher_forcing_ratio=0.0, train=False)
        loss = masked_cross_entropy(logits, captions, lengths, sample_mask)
        top5 = masked_top_k_accuracy(logits, captions, lengths, 5,
                                     sample_mask)
        return loss, top5, torch.argmax(logits, dim=-1)


def make_caption_steps(cfg: DecoderConfig, tcfg: TrainConfig,
                       optimizer: Adam, lang_optimizer: Adam,
                       factored: bool = True,
                       device="cuda") -> CaptionSteps:
    """Steps for the StyleNet (``factored``) or NIC captioner over cached
    pooled features.

    ``optimizer`` covers (decoder, encoder head), the factual track;
    ``lang_optimizer`` covers the decoder only, the emotion track
    (``train_multitask.py:163-167``).  ``device`` is CUDA unless the caller
    asks for the CPU; a step given tensors elsewhere raises.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return CaptionSteps(cfg, tcfg, optimizer, lang_optimizer, dev, factored)
