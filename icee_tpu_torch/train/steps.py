"""Training and validation steps of the global-feature captioners, StyleNet
(factored decoder) and NIC (port of
``icee_tpu/train/steps.py::make_caption_steps``), of the attention
captioners, StyleNet+Att and NIC+Att (``make_attention_steps``; see
:class:`AttentionSteps`), and of seq2seq style transfer
(``make_seq2seq_steps``; see :class:`Seq2SeqSteps`).

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

On a mesh (``mesh=``, :mod:`icee_tpu_torch.parallel`) every rank is given
the same GLOBAL batch and computes on its data coordinate's rows of it, as
JAX's jitted steps compute on a batch sharded over the data axis:

- the dropout keep-mask and the coins are drawn (or given) for the global
  batch, from the same generator state on every rank, and each rank keeps
  its rows, so the draws are the single-device run's;
- the packed-mean CE divides each rank's token sum by the GLOBAL batch's
  valid-token count (and the attention regulariser by its valid rows); a
  mean of per-rank means would be another loss wherever ranks hold
  different counts;
- the encoder head's BatchNorm normalizes by the global batch's statistics
  (``models/resnet.py::batch_norm_train``);
- each rank's loss is its share of the global loss, so the gradients are
  summed over the data group before the clamp and Adam, and every rank
  applies the same update; the returned loss is the global one;
- where the vocabulary divides the model axis, ``B`` / ``embed`` and the
  head hold this model rank's slice (``parallel/train.py::shard_decoder``):
  the embedding looks up its rows and sums over the model group, the
  scheduled-sampling argmax is taken over the whole vocabulary, and the
  loss is the vocab-parallel chunked CE (``ops/chunked_loss.py``), which a
  split head always takes (``chunked_ce`` off is for a whole head).

Validation on a mesh takes the WHOLE decoder (the trainers gather it) and
returns the global loss and top-5 and every row's predictions.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from icee_tpu_torch.core.config import (AttentionDecoderConfig,
                                        DecoderConfig, Seq2SeqConfig,
                                        TrainConfig)
from icee_tpu_torch.core.device import resolve_indexed_device
from icee_tpu_torch.evaluation.metrics import (length_mask,
                                               masked_cross_entropy,
                                               masked_top_k_accuracy)
from icee_tpu_torch.models import attention as att_mod
from icee_tpu_torch.models import encoder as enc_mod
from icee_tpu_torch.models import factored_lstm as fl
from icee_tpu_torch.models import lstm as nic
from icee_tpu_torch.models import seq2seq as s2s
from icee_tpu_torch.ops.chunked_loss import masked_ce_from_hiddens
from icee_tpu_torch.parallel.collectives import (all_reduce_grads,
                                                 gather_rows, reduced,
                                                 vocab_shard)
from icee_tpu_torch.parallel.data import local_rows
from icee_tpu_torch.train.optim import Adam, AdamState, tree_leaves

_STATE_KEYS = ("running_mean", "running_var")


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    top5: torch.Tensor


def _val_metrics(logits, targets, lengths, sample_mask,
                 count=None) -> StepMetrics:
    """Token-mean CE and top-5 accuracy (%) over the valid tokens
    (``count`` of them where given)."""
    return StepMetrics(
        loss=masked_cross_entropy(logits, targets, lengths, sample_mask,
                                  count),
        top5=masked_top_k_accuracy(logits, targets, lengths, 5, sample_mask,
                                   count))


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


class _Steps:
    """What the caption and attention steps share: the device, the
    optimizers, the kernel switches (``fused_scan`` / ``chunked_ce`` None =
    on for CUDA) and the device check."""

    def __init__(self, cfg: DecoderConfig, tcfg: TrainConfig,
                 optimizer: Adam, lang_optimizer: Adam,
                 device: torch.device, factored: bool = True, mesh=None,
                 split_vocab: bool = True):
        self.cfg, self.tcfg, self.device = cfg, tcfg, device
        self.factored = factored
        self.optimizer, self.lang_optimizer = optimizer, lang_optimizer
        on_card = device.type == "cuda"
        self.use_fused = on_card if tcfg.fused_scan is None else tcfg.fused_scan
        self.use_chunked = (on_card if tcfg.chunked_ce is None
                            else tcfg.chunked_ce)
        self.mesh = mesh
        self.group = None if mesh is None else mesh.data_group
        self.vocab = (vocab_shard(mesh, cfg.vocab_size) if split_vocab
                      else None)
        if self.vocab is not None:
            self.use_chunked = True

    # -- the data group ----------------------------------------------------

    def _draws(self, batch: int, steps: int, ratio, generator, keep, coins):
        """Under a data group: the keep-mask and coins of the GLOBAL batch
        (``batch`` rows, ``steps`` steps), drawn in the forward's order
        (``factored_lstm.prepare_inputs``) where not given, and this rank's
        rows of the keep-mask.  Without one: as given."""
        if self.group is None:
            return keep, coins
        gen = (torch.Generator().manual_seed(0) if generator is None
               else generator)
        if keep is None and self.cfg.dropout > 0.0:
            keep = torch.rand((batch, steps, self.cfg.embed_size),
                              generator=gen, device=gen.device) \
                < 1.0 - self.cfg.dropout
        if coins is None and float(ratio) < 1.0:
            coins = torch.rand((steps,), generator=gen,
                               device=gen.device) < ratio
        if keep is not None:
            keep = local_rows(torch.as_tensor(keep), self.mesh)
        return keep, coins

    def _count(self, lengths, t: int, sample_mask):
        """The global batch's valid-token count under a data group (None
        without one: the loss counts its own batch)."""
        if self.group is None:
            return None
        mask = length_mask(lengths, t)
        if sample_mask is not None:
            mask = mask & sample_mask[:, None].bool()
        return reduced(mask.sum(), self.group)

    def _global(self, x):
        """A per-rank share summed over the data group (no gradient)."""
        return reduced(x.detach(), self.group)

    def _reduce_grads(self, grads):
        return all_reduce_grads(grads, self.group)

    def _gather_preds(self, preds):
        if self.group is None:
            return preds
        return gather_rows(preds.contiguous(), self.group,
                           self.mesh.data_rank, self.mesh.n_data)

    def __iter__(self):
        return iter((self.factual_train_step, self.emotion_train_step,
                     self.val_step))

    def _check_device(self, *trees) -> None:
        for x in (leaf for t in trees for leaf in tree_leaves(t)):
            if x is not None and x.device != self.device:
                raise ValueError(f"step built for {self.device} was given "
                                 f"a tensor on {x.device}")

    def _head(self, d):
        return ((d["C_w"], d["C_b"]) if self.factored
                else (d["linear_w"], d["linear_b"]))


class CaptionSteps(_Steps):
    """The three steps of :func:`make_caption_steps`; unpacks as
    ``factual_train_step, emotion_train_step, val_step``.  ``factual_grads``
    and ``emotion_grads`` give a step's loss and pre-optimizer gradients."""

    def _forward(self, d, captions, feats, style, hiddens=False, **kw):
        """The decoder's training forward -> logits, or hidden states with
        ``hiddens`` (over a split vocabulary on a model group); NIC ignores
        ``style``."""
        if hiddens:
            kw["vocab"] = self.vocab
        if self.factored:
            fn = fl.forward_hiddens if hiddens else fl.forward
            return fn(d, self.cfg, captions, feats, style, **kw)
        fn = nic.forward_hiddens if hiddens else nic.forward
        return fn(d, self.cfg, captions, feats, **kw)

    def _train_loss(self, d, h, pooled, captions, lengths, sample_mask,
                    style, generator, keep, coins):
        """Masked token-mean CE of the training forward -> (loss, head
        with the forward's BatchNorm running statistics)."""
        feats, new_head = enc_mod.encode_global_from_pooled(
            h, pooled, train=True, group=self.group)
        count = self._count(lengths, captions.shape[1], sample_mask)
        kw = dict(teacher_forcing_ratio=self.tcfg.teacher_forcing_ratio,
                  generator=generator, train=True, fused_scan=self.use_fused,
                  keep=keep, coins=coins)
        if not self.use_chunked:
            logits = self._forward(d, captions, feats, style, **kw)
            return masked_cross_entropy(logits, captions, lengths,
                                        sample_mask, count), new_head
        hiddens = self._forward(d, captions, feats, style, hiddens=True,
                                **kw)
        return masked_ce_from_hiddens(hiddens, *self._head(d), captions,
                                      lengths, sample_mask, count=count,
                                      vocab=self.vocab), new_head

    def _grads(self, dec, head, track_head, pooled, captions, lengths,
               sample_mask, style, generator, keep, coins):
        self._check_device(dec, head, pooled, captions, lengths, sample_mask)
        keep, coins = self._draws(*captions.shape,
                                  self.tcfg.teacher_forcing_ratio,
                                  generator, keep, coins)
        pooled, captions, lengths, sample_mask = local_rows(
            (pooled, captions, lengths, sample_mask), self.mesh)
        with torch.enable_grad():
            d = _track(dec)
            h = _track(head) if track_head else head
            loss, new_head = self._train_loss(d, h, pooled, captions,
                                              lengths, sample_mask, style,
                                              generator, keep, coins)
            grads = _grads_like((d, h) if track_head else d, loss)
        return self._global(loss), self._reduce_grads(grads), new_head

    def factual_grads(self, dec, head, pooled, captions, lengths,
                      sample_mask, generator=None, keep=None, coins=None):
        """-> (loss, (decoder grads, head grads), forward head)."""
        return self._grads(dec, head, True, pooled, captions, lengths,
                           sample_mask, 0, generator, keep, coins)

    def emotion_grads(self, dec, head, pooled, captions, lengths,
                      sample_mask, style, generator=None, keep=None,
                      coins=None):
        """-> (loss, decoder grads, forward head)."""
        return self._grads(dec, head, False, pooled, captions, lengths,
                           sample_mask, int(style), generator, keep, coins)

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
        pooled, captions, lengths, sample_mask = local_rows(
            (pooled, captions, lengths, sample_mask), self.mesh)
        feats = enc_mod.encode_global_from_pooled(head, pooled)
        logits = self._forward(dec, captions, feats, int(style),
                               teacher_forcing_ratio=0.0, train=False)
        m = _val_metrics(logits, captions, lengths, sample_mask,
                         self._count(lengths, captions.shape[1],
                                     sample_mask))
        return (self._global(m.loss), self._global(m.top5),
                self._gather_preds(torch.argmax(logits, dim=-1)))


def make_caption_steps(cfg: DecoderConfig, tcfg: TrainConfig,
                       optimizer: Adam, lang_optimizer: Adam,
                       factored: bool = True, device="cuda",
                       mesh=None) -> CaptionSteps:
    """Steps for the StyleNet (``factored``) or NIC captioner over cached
    pooled features.

    ``optimizer`` covers (decoder, encoder head), the factual track;
    ``lang_optimizer`` covers the decoder only, the emotion track
    (``train_multitask.py:163-167``).  ``device`` is CUDA unless the caller
    asks for the CPU; a step given tensors elsewhere raises.  ``mesh``: the
    data- and tensor-parallel steps of the module docstring.
    """
    return CaptionSteps(cfg, tcfg, optimizer, lang_optimizer,
                        resolve_indexed_device(device), factored, mesh)


class AttentionSteps(_Steps):
    """The steps of :func:`make_attention_steps` (port of
    ``icee_tpu/train/steps.py::make_attention_steps``); unpacks as
    ``factual_train_step, emotion_train_step, val_step``.

    The spatial features are the encoder's output and it has no trainable
    parameters, so both optimizers cover the whole decoder
    (``train_multitask_att.py:165-166``).  The model consumes
    ``captions[:, :-1]`` and predicts ``captions[:, 1:]`` with lengths - 1
    (``train_multitask_att.py:308-311``); the loss is the masked token-mean
    CE plus ``alpha_c`` times the doubly-stochastic regulariser
    ``mean((1 - sum_t alpha)^2)`` over valid steps and rows (``:322-323``).
    On CUDA the decoder runs K5 (``ops/att_scan.py``), teacher-forced at
    ratio 1.0 and sampled below, and the loss the chunked CE kernels; NIC+Att
    (``factored=False``) ignores ``style``.
    """

    def _forward(self, d, captions, feats, style, hiddens=False, **kw):
        if hiddens:
            kw["vocab"] = self.vocab
        if self.factored:
            fn = (att_mod.factored_att_forward_hiddens if hiddens
                  else att_mod.factored_att_forward)
            return fn(d, self.cfg, captions, feats, style, **kw)
        fn = (att_mod.rnn_att_forward_hiddens if hiddens
              else att_mod.rnn_att_forward)
        return fn(d, self.cfg, captions, feats, **kw)

    def _att_reg(self, alphas, tgt_len, sample_mask):
        """mean over valid rows and positions of (1 - sum_t alpha)^2, the
        steps past a caption's length contributing no attention; the valid
        rows of the global batch under a data group."""
        mask = length_mask(tgt_len, alphas.shape[1]) & sample_mask[:, None]
        a = torch.where(mask[..., None], alphas, 0.0)
        rows = sample_mask.to(alphas.dtype)
        n_valid = reduced(rows.sum(), self.group).clamp(min=1)
        return torch.sum((1.0 - a.sum(1)) ** 2 * rows[:, None]) / (
            n_valid * alphas.shape[-1])

    def _loss(self, d, features, captions, lengths, sample_mask, style,
              chunked, **kw):
        """-> (CE + alpha_c x regulariser, logits or None, targets,
        target lengths)."""
        captions_in, targets = captions[:, :-1], captions[:, 1:]
        tgt_len = (lengths - 1).clamp(min=0)
        sample_mask = sample_mask.bool()
        count = self._count(tgt_len, targets.shape[1], sample_mask)
        if chunked:
            hiddens, alphas = self._forward(d, captions_in, features, style,
                                            hiddens=True, **kw)
            ce, logits = masked_ce_from_hiddens(
                hiddens, *self._head(d), targets, tgt_len,
                sample_mask, count=count, vocab=self.vocab), None
        else:
            logits, alphas = self._forward(d, captions_in, features, style,
                                           **kw)
            ce = masked_cross_entropy(logits, targets, tgt_len, sample_mask,
                                      count)
        reg = self._att_reg(alphas, tgt_len, sample_mask)
        return (ce + self.tcfg.alpha_c * reg, logits, targets, tgt_len,
                count)

    def _grads(self, dec, features, captions, lengths, sample_mask, style,
               generator, keep, coins):
        self._check_device(dec, features, captions, lengths, sample_mask)
        keep, coins = self._draws(captions.shape[0], captions.shape[1] - 1,
                                  self.tcfg.teacher_forcing_ratio,
                                  generator, keep, coins)
        features, captions, lengths, sample_mask = local_rows(
            (features, captions, lengths, sample_mask), self.mesh)
        with torch.enable_grad():
            d = _track(dec)
            loss = self._loss(
                d, features, captions, lengths, sample_mask, style,
                self.use_chunked,
                teacher_forcing_ratio=self.tcfg.teacher_forcing_ratio,
                generator=generator, train=True, fused_scan=self.use_fused,
                keep=keep, coins=coins)[0]
            grads = self._reduce_grads(_grads_like(d, loss))
        return self._global(loss), grads

    def factual_grads(self, dec, features, captions, lengths, sample_mask,
                      generator=None, keep=None, coins=None):
        """-> (loss, decoder grads) of the factual track (style 0)."""
        return self._grads(dec, features, captions, lengths, sample_mask, 0,
                           generator, keep, coins)

    def emotion_grads(self, dec, features, captions, lengths, sample_mask,
                      style, generator=None, keep=None, coins=None):
        """-> (loss, decoder grads) of the emotion track for ``style``."""
        return self._grads(dec, features, captions, lengths, sample_mask,
                           int(style), generator, keep, coins)

    def factual_train_step(self, dec, opt_state: AdamState, features,
                           captions, lengths, sample_mask, generator=None,
                           keep=None, coins=None):
        """-> (dec, opt_state, loss), the decoder updated in place."""
        loss, grads = self.factual_grads(dec, features, captions, lengths,
                                         sample_mask, generator, keep, coins)
        self.optimizer.update(grads, opt_state, dec)
        return dec, opt_state, loss

    def emotion_train_step(self, dec, opt_state: AdamState, features,
                           captions, lengths, sample_mask, style,
                           generator=None, keep=None, coins=None):
        """The emotion (language) track: ``lang_optimizer``, in place."""
        loss, grads = self.emotion_grads(dec, features, captions, lengths,
                                         sample_mask, style, generator, keep,
                                         coins)
        self.lang_optimizer.update(grads, opt_state, dec)
        return dec, opt_state, loss

    @torch.no_grad()
    def val_step(self, dec, features, captions, lengths, sample_mask,
                 style) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Free-running (ratio 0) forward -> (loss with the regulariser,
        top-5 %, argmax preds (B, T - 1))."""
        self._check_device(dec, features, captions, lengths, sample_mask)
        features, captions, lengths, sample_mask = local_rows(
            (features, captions, lengths, sample_mask), self.mesh)
        loss, logits, targets, tgt_len, count = self._loss(
            dec, features, captions, lengths, sample_mask, int(style), False,
            teacher_forcing_ratio=0.0, train=False)
        top5 = masked_top_k_accuracy(logits, targets, tgt_len, 5,
                                     sample_mask.bool(), count)
        return (self._global(loss), self._global(top5),
                self._gather_preds(torch.argmax(logits, dim=-1)))


def make_attention_steps(cfg: AttentionDecoderConfig, tcfg: TrainConfig,
                         optimizer: Adam, lang_optimizer: Adam,
                         factored: bool = True, device="cuda",
                         mesh=None) -> AttentionSteps:
    """Steps for the StyleNet+Att (``factored``) or NIC+Att captioner over
    spatial features (B, P, feature_size).  ``device`` is CUDA unless the
    caller asks for the CPU; a step given tensors elsewhere raises.
    ``mesh`` as in :func:`make_caption_steps`."""
    return AttentionSteps(cfg, tcfg, optimizer, lang_optimizer,
                          resolve_indexed_device(device), factored, mesh)


class TextStyleStep(_Steps):
    """The paper regime's text-only emotion step (``icee_tpu/train/loops.py``
    ``PaperRegimeTrainer``): the StyleNet decoder's training forward with
    no features (step t consumes ``captions[:, t]``), the masked token-mean
    CE, then ``optimizer`` (one style's S slice, ``optim.make_style_adam``)
    in place.  On CUDA the teacher-forced forward runs K3 and the loss the
    chunked CE kernels, as in :class:`CaptionSteps`."""

    def __init__(self, cfg: DecoderConfig, tcfg: TrainConfig,
                 optimizer: Adam, device="cuda", mesh=None):
        super().__init__(cfg, tcfg, optimizer, optimizer,
                         resolve_indexed_device(device), mesh=mesh)

    def __call__(self, dec, opt_state: AdamState, captions, lengths,
                 sample_mask, style, generator=None, keep=None, coins=None):
        """-> (dec, opt_state, loss), the decoder updated in place."""
        loss, grads = self.grads(dec, captions, lengths, sample_mask, style,
                                 generator, keep, coins)
        self.optimizer.update(grads, opt_state, dec)
        return dec, opt_state, loss

    def grads(self, dec, captions, lengths, sample_mask, style,
              generator=None, keep=None, coins=None):
        """-> (loss, decoder grads) of the global batch: each rank's share
        summed over the data group."""
        self._check_device(dec, captions, lengths, sample_mask)
        keep, coins = self._draws(*captions.shape,
                                  self.tcfg.teacher_forcing_ratio,
                                  generator, keep, coins)
        captions, lengths, sample_mask = local_rows(
            (captions, lengths, sample_mask), self.mesh)
        count = self._count(lengths, captions.shape[1], sample_mask)
        with torch.enable_grad():
            d = _track(dec)
            kw = dict(teacher_forcing_ratio=self.tcfg.teacher_forcing_ratio,
                      generator=generator, train=True,
                      fused_scan=self.use_fused, keep=keep, coins=coins)
            if self.use_chunked:
                hiddens = fl.forward_hiddens(d, self.cfg, captions, None,
                                             int(style), vocab=self.vocab,
                                             **kw)
                loss = masked_ce_from_hiddens(hiddens, d["C_w"], d["C_b"],
                                              captions, lengths, sample_mask,
                                              count=count, vocab=self.vocab)
            else:
                logits = fl.forward(d, self.cfg, captions, None, int(style),
                                    **kw)
                loss = masked_cross_entropy(logits, captions, lengths,
                                            sample_mask, count)
            grads = self._reduce_grads(_grads_like(d, loss))
        return self._global(loss), grads


class Seq2SeqSteps(_Steps):
    """The steps of :func:`make_seq2seq_steps` (port of
    ``icee_tpu/train/steps.py::make_seq2seq_steps``, the T6 regime); unpacks
    as ``factual_train_step, emotion_train_step, val_factual_step,
    val_emotion_step``.

    The factual step trains the encoder half and the encoder head (its
    BatchNorm in training mode, the forward's running statistics kept) on
    the feature-prefixed autoencoding pass, targets the un-shifted caption.
    The emotion step trains the stacked decoders on ``captions_dst[:, :-1]``
    -> ``captions_dst[:, 1:]`` with lengths - 1, from a zero state: the
    reference's ``DecoderRNN.forward`` drops the encoder state, so the
    encoder pass (and the head's features, which only feed it) is dead in
    that loss and is skipped, as JAX's chunked path skips it.  The other
    emotions' gradient slices are zeroed, and ``emotion_optimizer`` is ONE
    Adam over the stacked tensors, as in JAX: the other emotions' moments
    still decay and their weights still move by the bias-corrected m /
    sqrt(v) after their own steps.  On CUDA (``chunked_ce`` None) both
    losses run the chunked CE kernels; no kernel runs the recurrence (JAX
    runs it in ``lax.scan``).  ``keep`` / ``coins`` are one pass's injected
    draws (the JAX step draws the emotion pass's from the second half of
    its key's split)."""

    def __iter__(self):
        return iter((self.factual_train_step, self.emotion_train_step,
                     self.val_factual_step, self.val_emotion_step))

    def factual_grads(self, params, head, pooled, captions, lengths,
                      sample_mask, generator=None, keep=None, coins=None):
        """-> (loss, (encoder-half grads, head grads), forward head)."""
        self._check_device(params, head, pooled, captions, lengths,
                           sample_mask)
        ratio = self.tcfg.teacher_forcing_ratio
        keep, coins = self._draws(*captions.shape, ratio, generator, keep,
                                  coins)
        pooled, captions, lengths, sample_mask = local_rows(
            (pooled, captions, lengths, sample_mask), self.mesh)
        count = self._count(lengths, captions.shape[1], sample_mask)
        with torch.enable_grad():
            enc, h = _track(params["encoder"]), _track(head)
            feats, new_head = enc_mod.encode_global_from_pooled(
                h, pooled, True, group=self.group)
            p = dict(params, encoder=enc)
            out, _ = s2s.encode(p, self.cfg, feats, captions, ratio,
                                generator, True, self.use_chunked, keep,
                                coins)
            if self.use_chunked:
                loss = masked_ce_from_hiddens(
                    out, enc["linear_w"], enc["linear_b"], captions,
                    lengths, sample_mask, count=count)
            else:
                loss = masked_cross_entropy(out, captions, lengths,
                                            sample_mask, count)
            grads = _grads_like((enc, h), loss)
        return self._global(loss), self._reduce_grads(grads), new_head

    def emotion_grads(self, params, captions_dst, dst_lengths, sample_mask,
                      emotion, generator=None, keep=None, coins=None):
        """-> (loss, stacked-decoder grads with the other emotions' slices
        zeroed)."""
        self._check_device(params, captions_dst, dst_lengths, sample_mask)
        emotion = int(emotion)
        keep, coins = self._draws(captions_dst.shape[0],
                                  captions_dst.shape[1] - 1,
                                  self.tcfg.teacher_forcing_ratio, generator,
                                  keep, coins)
        captions_dst, dst_lengths, sample_mask = local_rows(
            (captions_dst, dst_lengths, sample_mask), self.mesh)
        tgt_len = (dst_lengths - 1).clamp(min=0)
        count = self._count(tgt_len, captions_dst.shape[1] - 1, sample_mask)
        with torch.enable_grad():
            decs = _track(params["decoders"])
            p = dict(params, decoders=decs)
            out = s2s.decode_emotion(
                p, self.cfg, None, captions_dst[:, :-1], emotion,
                self.tcfg.teacher_forcing_ratio, generator, True,
                self.use_chunked, keep, coins)
            if self.use_chunked:
                half = s2s.select_decoder(p, emotion)
                loss = masked_ce_from_hiddens(
                    out, half["linear_w"], half["linear_b"],
                    captions_dst[:, 1:], tgt_len, sample_mask, count=count)
            else:
                loss = masked_cross_entropy(out, captions_dst[:, 1:],
                                            tgt_len, sample_mask, count)
            grads = _grads_like(decs, loss)

        def only(g):
            if isinstance(g, dict):
                return {k: only(v) for k, v in g.items()}
            if isinstance(g, (list, tuple)):
                return type(g)(only(v) for v in g)
            onehot = torch.zeros((3,) + (1,) * (g.dim() - 1), dtype=g.dtype,
                                 device=g.device)
            onehot[emotion] = 1.0
            return g * onehot

        return self._global(loss), self._reduce_grads(only(grads))

    def factual_train_step(self, params, head, opt_state: AdamState, pooled,
                           captions, lengths, sample_mask, generator=None,
                           keep=None, coins=None):
        """The optimizer covers (encoder half, head).  -> (params, head,
        opt_state, loss), the trees updated in place."""
        loss, grads, new_head = self.factual_grads(
            params, head, pooled, captions, lengths, sample_mask, generator,
            keep, coins)
        self.optimizer.update(grads, opt_state, (params["encoder"], head))
        _merge_bn_stats(head, new_head)
        return params, head, opt_state, loss

    def emotion_train_step(self, params, head, opt_state: AdamState, pooled,
                           captions_src, src_lengths, captions_dst,
                           dst_lengths, sample_mask, emotion, generator=None,
                           keep=None, coins=None):
        """``emotion_optimizer`` over the stacked decoders.  ``head``,
        ``pooled``, ``captions_src`` and ``src_lengths`` feed only the dead
        encoder pass (kept for the JAX step's signature).  -> (params,
        opt_state, loss), the decoders updated in place."""
        loss, grads = self.emotion_grads(params, captions_dst, dst_lengths,
                                         sample_mask, emotion, generator,
                                         keep, coins)
        self.lang_optimizer.update(grads, opt_state, params["decoders"])
        return params, opt_state, loss

    @torch.no_grad()
    def val_factual_step(self, params, head, pooled, captions, lengths,
                         sample_mask):
        """The encoder pass at ratio 0 (free-running from step 0), the head
        in eval mode -> (loss, top-5 %, argmax preds)."""
        self._check_device(params, head, pooled, captions, lengths,
                           sample_mask)
        pooled, captions, lengths, sample_mask = local_rows(
            (pooled, captions, lengths, sample_mask), self.mesh)
        feats = enc_mod.encode_global_from_pooled(head, pooled)
        logits, _ = s2s.encode(params, self.cfg, feats, captions, 0.0,
                               None, False)
        m = _val_metrics(logits, captions, lengths, sample_mask,
                         self._count(lengths, captions.shape[1],
                                     sample_mask))
        return (self._global(m.loss), self._global(m.top5),
                self._gather_preds(torch.argmax(logits, dim=-1)))

    @torch.no_grad()
    def val_emotion_step(self, params, head, pooled, captions_src,
                         src_lengths, captions_dst, dst_lengths, sample_mask,
                         emotion):
        """The emotion decoder at ratio 0 on ``captions_dst[:, :-1]`` ->
        (loss, top-5 %, argmax preds (B, T - 1)) against ``captions_dst[:,
        1:]``; the encoder pass is dead here too."""
        self._check_device(params, captions_dst, dst_lengths, sample_mask)
        captions_dst, dst_lengths, sample_mask = local_rows(
            (captions_dst, dst_lengths, sample_mask), self.mesh)
        logits = s2s.decode_emotion(params, self.cfg, None,
                                    captions_dst[:, :-1], int(emotion), 0.0,
                                    None, False)
        tgt_len = (dst_lengths - 1).clamp(min=0)
        m = _val_metrics(logits, captions_dst[:, 1:], tgt_len, sample_mask,
                         self._count(tgt_len, logits.shape[1], sample_mask))
        return (self._global(m.loss), self._global(m.top5),
                self._gather_preds(torch.argmax(logits, dim=-1)))


def make_seq2seq_steps(cfg: Seq2SeqConfig, tcfg: TrainConfig,
                       optimizer: Adam, emotion_optimizer: Adam,
                       device="cuda", mesh=None) -> Seq2SeqSteps:
    """T6 steps.  ``optimizer`` covers (encoder half, encoder head);
    ``emotion_optimizer`` the stacked emotion decoders, each step's
    gradient masked to its emotion's slice (the reference keeps one Adam
    per emotion decoder, ``seq2seq/train.py:141-158``; JAX and the port
    one masked Adam).  ``device`` is CUDA unless the caller asks for the
    CPU; a step given tensors elsewhere raises.  ``mesh``: data parallel
    only, the parameters whole on every rank, as JAX replicates them."""
    return Seq2SeqSteps(cfg, tcfg, optimizer, emotion_optimizer,
                        resolve_indexed_device(device), mesh=mesh,
                        split_vocab=False)
