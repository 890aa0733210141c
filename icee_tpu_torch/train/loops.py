"""Training regimes as host-side epoch drivers over the training steps (port
of ``icee_tpu/train/loops.py``'s host loop: ``MultitaskTrainer``,
``TransferTrainer`` and ``PaperRegimeTrainer`` on the host loader).

All regimes share the reference's control policy (``train_multitask.py:
180-269``): per-epoch factual track then the emotion track, teacher-forced
training and free-running validation with loss / perplexity / top-5 /
corpus BLEU-4, LR x0.8 after every 4 non-improving epochs of a track, early
stop once both tracks reach 10, best-BLEU checkpointing, and a beam-decoded
sample caption printed per validation.  The JSONL events (``epoch_factual``,
``epoch_emotion``, ``lr_decay``, ``early_stop``) are the JAX package's.

Batches come from :mod:`icee_tpu_torch.data.pipeline` as NumPy; the
trainer moves them to its device (CUDA unless the caller asks for the CPU)
and reads each step's loss, as the JAX loop does.  On CUDA the steps launch
the hand-written kernels (K3 or K4 on the teacher-forced global families,
K5 on the attention families, the chunked CE on all) and the default sample
one K2 search; on the CPU they run the kernels' plain versions.

Randomness: a ``torch.Generator`` seeded from ``tcfg.seed`` on the
trainer's device drives the dropout keep-mask and the teacher-forcing
coins.  ``draws(batch, steps) -> (keep, coins)``, when given, is called
once per training step instead (the JAX loop splits its key once per
training step and never on validation), and its results are passed to the
step as ``keep=`` / ``coins=``: this is how the tests hand the port the
JAX package's draws, which torch cannot reproduce.

Not ported yet, each refused with ``NotImplementedError`` naming its slice:
the device-resident loaders (``DeviceCaptionData``) and
``tcfg.progress_chunk`` (slice 3c), ``mesh`` (slice 8) and
``Seq2SeqTrainer`` (slice 6).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from icee_tpu_torch.checkpoint.ckpt import (CheckpointState, load_checkpoint,
                                            save_checkpoint)
from icee_tpu_torch.core.config import (EMOTIONS, DecoderConfig, TrainConfig,
                                        mode_id)
from icee_tpu_torch.core.device import resolve_indexed_device
from icee_tpu_torch.evaluation.bleu import corpus_bleu
from icee_tpu_torch.evaluation.metrics import AverageMeter, perplexity
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.steps import (TextStyleStep, make_attention_steps,
                                        make_caption_steps)
from icee_tpu_torch.utils.logging import MetricsLogger

FAMILIES = ("factored", "nic", "factored_att", "nic_att")


def strip_specials(ids: Sequence[int], start: int, end: int) -> List[int]:
    """Drop <start>/<end> ids (val BLEU pre-processing,
    ``train_multitask.py:316-333``)."""
    return [int(w) for w in ids if w != start and w != end]


def _log(log_path: Optional[str], text: str) -> None:
    print(text)
    if log_path:
        with open(log_path, "a+") as f:
            f.write(text + "\n")


def _clone(tree, device):
    """A copy of a tensor tree on ``device`` (the trainer trains its own
    copies, in place)."""
    if isinstance(tree, dict):
        return {k: _clone(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v, device) for v in tree)
    if tree is None:
        return None
    return torch.as_tensor(tree).to(device, copy=True)


def _refuse_device_data(loader) -> None:
    """The JAX package's device-resident loaders have no port yet."""
    if any(c.__name__ == "DeviceCaptionData" for c in type(loader).__mro__):
        raise NotImplementedError(
            "device-resident loaders (DeviceCaptionData and its device "
            "epochs) come with slice 3c of the port; use the host loaders "
            "of icee_tpu_torch.data.pipeline")


@dataclasses.dataclass
class EpochStats:
    loss: float
    top5: float = 0.0
    bleu4: float = 0.0
    batch_time: float = 0.0


class MultitaskTrainer:
    """T2/T3 (and the NIC copies): interleaved factual + single-emotion
    training with BLEU-driven plateau control.

    ``family``: 'factored' | 'nic' | 'factored_att' | 'nic_att'.  Loaders
    yield :class:`icee_tpu_torch.data.pipeline.CaptionBatch` whose ``images``
    hold encoder features: pooled (B, 2048) for the global families,
    spatial (B, P, 2048) for the attention families.  ``dec_params`` and
    ``head_params`` (None for the attention families) are copied to
    ``device``; the trainer updates its copies in place.
    """

    def __init__(
        self,
        cfg: DecoderConfig,
        tcfg: TrainConfig,
        vocab,
        dec_params,
        head_params=None,
        family: str = "factored",
        sample_fn: Optional[Callable] = None,
        log_path: Optional[str] = None,
        model_dir: str = "models",
        data_name: str = "flickr8k_id",
        metrics_path: Optional[str] = None,
        mesh=None,
        device="cuda",
        draws: Optional[Callable] = None,
    ) -> None:
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r}; choose one of "
                             f"{FAMILIES}")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device training (mesh) comes with slice 8 of the port")
        if tcfg.progress_chunk:
            raise NotImplementedError(
                "mid-epoch progress checkpoints (tcfg.progress_chunk) come "
                "with slice 3c of the port; set progress_chunk=0")
        self.cfg, self.tcfg, self.vocab = cfg, tcfg, vocab
        self.family = family
        self.attention = family.endswith("_att")
        self.factored = family.startswith("factored")
        self.device = resolve_indexed_device(device)
        self.dec = _clone(dec_params, self.device)
        self.head = _clone(head_params, self.device)
        self.sample_fn = sample_fn
        self.log_path = log_path
        self.model_dir = model_dir
        self.data_name = data_name
        self.metrics = MetricsLogger(metrics_path)
        self.generator = torch.Generator(device=self.device).manual_seed(
            tcfg.seed)
        self.draws = draws

        self.optimizer = optim.make_adam(tcfg.lr_caption, tcfg)
        self.lang_optimizer = optim.make_adam(tcfg.lr_language, tcfg)
        self._build_steps()
        if self.attention:
            self.opt_state = self.optimizer.init(self.dec)
        else:
            self.opt_state = self.optimizer.init((self.dec, self.head))
        self.lang_opt_state = self.lang_optimizer.init(self.dec)

        self.epochs_since_improvement = {"factual": 0, "emotion": 0}
        self.best_bleu4 = {"factual": 0.0, "emotion": 0.0}
        self.start_epoch = 0
        if self.sample_fn is None and not self.attention:
            self.sample_fn = self._default_sample_fn

    def _build_steps(self) -> None:
        make = make_attention_steps if self.attention else make_caption_steps
        self.steps = make(self.cfg, self.tcfg, self.optimizer,
                          self.lang_optimizer, self.factored,
                          device=self.device)
        self.factual_step, self.emotion_step, self.val_step = self.steps

    def _to_device(self, *arrays):
        """Host batch arrays -> tensors on the trainer's device: features
        float32, ids and lengths int64, the sample mask bool."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if t.is_floating_point():
                t = t.float()
            elif t.dtype != torch.bool:
                t = t.long()
            out.append(t.to(self.device))
        return tuple(out)

    @torch.no_grad()
    def _default_sample_fn(self, dec, head, feat, style):
        """Beam-decode one caption at k = 5 from a pooled feature (the
        per-validation sample print, ``train_multitask.py:344-359``): the
        head's feature is the step-1 input, tiled over the beams, through
        one K2 search (its plain version on the CPU)."""
        from icee_tpu_torch.decode.fast import factored_decode, nic_decode
        from icee_tpu_torch.models import encoder as enc_mod

        k = 5
        feats_head = enc_mod.encode_global_from_pooled(head, feat)
        tiled = feats_head[:, None, :].expand(1, k, feats_head.shape[1])
        common = (1, k, self.cfg.max_seq_length, self.vocab.start,
                  self.vocab.end)
        if self.factored:
            res = factored_decode("mega", dec, tiled.contiguous(), int(style),
                                  *common)
        else:
            res = nic_decode(dec, tiled.contiguous(), *common)
        ids = res.tokens[0][: int(res.length[0])].tolist()
        words = []
        for wid in ids:
            words.append(self.vocab.idx2word[int(wid)])
            if words[-1] == "<end>":
                break
        return words

    # -- single epochs ----------------------------------------------------

    def _step_randomness(self, batch: int, steps: int) -> dict:
        """One training step's randomness: the injected draws, or the
        trainer's generator."""
        if self.draws is None:
            return {"generator": self.generator}
        keep, coins = self.draws(batch, steps)
        return {"keep": keep, "coins": coins}

    def _run_train(self, loader, style: Optional[int], log_step: int,
                   tag: str) -> EpochStats:
        _refuse_device_data(loader)
        losses = AverageMeter()
        t0 = time.time()
        for i, batch in enumerate(loader):
            feats, caps, lens, smask = self._to_device(
                batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            kw = self._step_randomness(batch.batch_size,
                                       caps.shape[1] - int(self.attention))
            if style is None or style == 0:
                if self.attention:
                    self.dec, self.opt_state, loss = self.factual_step(
                        self.dec, self.opt_state, feats, caps, lens, smask,
                        **kw)
                else:
                    self.dec, self.head, self.opt_state, loss = \
                        self.factual_step(self.dec, self.head, self.opt_state,
                                          feats, caps, lens, smask, **kw)
            else:
                if self.attention:
                    self.dec, self.lang_opt_state, loss = self.emotion_step(
                        self.dec, self.lang_opt_state, feats, caps, lens,
                        smask, style, **kw)
                else:
                    self.dec, self.head, self.lang_opt_state, loss = \
                        self.emotion_step(self.dec, self.head,
                                          self.lang_opt_state, feats, caps,
                                          lens, smask, style, **kw)
            loss = float(loss)
            if i % log_step == 0:
                print(f"Step [{i}/{len(loader)}], [{tag}], Loss: {loss:.4f}")
            losses.update(loss, int(batch.lengths.sum()))
        return EpochStats(loss=losses.avg, batch_time=time.time() - t0)

    def _run_val(self, loader, style: int) -> EpochStats:
        _refuse_device_data(loader)
        losses, top5s = AverageMeter(), AverageMeter()
        references, hypotheses = [], []
        start, end = self.vocab.start, self.vocab.end
        shift = 1 if self.attention else 0
        t0 = time.time()
        last_feat = None
        for batch in loader:
            feats, caps, lens, smask = self._to_device(
                batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            loss, top5, preds = self.val_step(
                self.dec, *(() if self.attention else (self.head,)),
                feats, caps, lens, smask, style)
            n_tok = int(batch.lengths.sum())
            losses.update(float(loss), n_tok)
            top5s.update(float(top5), n_tok)
            preds = preds.cpu().numpy()
            for b in range(batch.batch_size):
                if not batch.sample_mask[b]:
                    continue
                references.append([strip_specials(r, start, end)
                                   for r in batch.references[b]])
                L = max(int(batch.lengths[b]) - shift, 0)
                hypotheses.append(
                    strip_specials(preds[b, :L].tolist(), start, end))
            last_feat = feats
        bleu4 = corpus_bleu(references, hypotheses)
        if self.sample_fn is not None and last_feat is not None:
            print(self.sample_fn(self.dec, self.head, last_feat[0:1], style))
        return EpochStats(loss=losses.avg, top5=top5s.avg, bleu4=bleu4,
                          batch_time=time.time() - t0)

    def _improved(self, track: str, bleu4: float) -> bool:
        """Best-BLEU bookkeeping of one track -> whether it improved."""
        is_best = bleu4 > self.best_bleu4[track]
        self.best_bleu4[track] = max(bleu4, self.best_bleu4[track])
        self.epochs_since_improvement[track] = (
            0 if is_best else self.epochs_since_improvement[track] + 1)
        return is_best

    # -- full regime ------------------------------------------------------

    def train(self, data_loader, val_loader, emotion_loader,
              val_emotion_loader, num_epochs: Optional[int] = None) -> Dict:
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        emo = mode_id(tcfg.mode)
        tag = tcfg.mode[:3].upper()
        for epoch in range(self.start_epoch, num_epochs):
            imp_fac = self.epochs_since_improvement["factual"]
            imp_emo = self.epochs_since_improvement["emotion"]
            if imp_fac >= tcfg.early_stop_patience and \
                    imp_emo >= tcfg.early_stop_patience:
                self.metrics.log("early_stop", epoch=epoch, imp_fac=imp_fac,
                                 imp_emo=imp_emo)
                break
            if imp_fac > 0 and imp_fac % tcfg.lr_decay_patience == 0:
                lr = optim.decay_lr(self.opt_state, tcfg.lr_decay_factor)
                _log(self.log_path, f"DECAYING learning rate to {lr:f}")
                self.metrics.log("lr_decay", epoch=epoch, track="factual",
                                 lr=lr)
            if imp_emo > 0 and imp_emo % tcfg.lr_decay_patience == 0:
                lr = optim.decay_lr(self.lang_opt_state, tcfg.lr_decay_factor)
                _log(self.log_path,
                     f"DECAYING language learning rate to {lr:f}")
                self.metrics.log("lr_decay", epoch=epoch, track="emotion",
                                 lr=lr)

            # factual track
            tr = self._run_train(data_loader, 0, tcfg.log_step, "FAC")
            va = self._run_val(val_loader, 0)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [FAC], "
                 f"Batch Time: {tr.batch_time + va.batch_time:.3f}, "
                 f"Top-5 Acc: {va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                 f"\tTrain Loss: {tr.loss:.4f} | "
                 f"Train Perplexity: {perplexity(tr.loss):5.4f}\n"
                 f"\tVal   Loss: {va.loss:.4f} | "
                 f"Val   Perplexity: {perplexity(va.loss):5.4f}")
            self.metrics.log("epoch_factual", epoch=epoch,
                             train_loss=tr.loss, val_loss=va.loss,
                             top5=va.top5, bleu4=va.bleu4,
                             lr=optim.get_lr(self.opt_state))
            self._improved("factual", va.bleu4)

            # emotion track (single --mode emotion, train_multitask.py:139-147)
            tr_e = self._run_train(emotion_loader, emo, tcfg.log_step_emotion,
                                   tag)
            va_e = self._run_val(val_emotion_loader, emo)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [{tag}], "
                 f"Top-5 Acc: {va_e.top5:.3f}, BLEU-4 Score: {va_e.bleu4}\n"
                 f"\tTrain Loss: {tr_e.loss:.4f} | "
                 f"Train Perplexity: {perplexity(tr_e.loss):5.4f}\n"
                 f"\tVal   Loss: {va_e.loss:.4f} | "
                 f"Val   Perplexity: {perplexity(va_e.loss):5.4f}")
            self.metrics.log("epoch_emotion", epoch=epoch, mode=tcfg.mode,
                             train_loss=tr_e.loss, val_loss=va_e.loss,
                             top5=va_e.top5, bleu4=va_e.bleu4,
                             lr=optim.get_lr(self.lang_opt_state))
            self.save(epoch, self._improved("emotion", va_e.bleu4))
        return {"best_bleu4": self.best_bleu4}

    def train_factual_only(self, data_loader, val_loader,
                           num_epochs: Optional[int] = None) -> Dict:
        """T4: stage-1 factual pretraining (``train_transfer_fac.py:83-160``);
        produces the FAC_BEST checkpoint the transfer stage resumes from."""
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        for epoch in range(self.start_epoch, num_epochs):
            imp = self.epochs_since_improvement["factual"]
            if imp >= tcfg.early_stop_patience:
                break
            if imp > 0 and imp % tcfg.lr_decay_patience == 0:
                optim.decay_lr(self.opt_state, tcfg.lr_decay_factor)
            tr = self._run_train(data_loader, 0, tcfg.log_step, "FAC")
            va = self._run_val(val_loader, 0)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [FAC], Top-5 Acc: "
                 f"{va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                 f"\tTrain Loss: {tr.loss:.4f} | Val Loss: {va.loss:.4f}")
            self.save(epoch, self._improved("factual", va.bleu4),
                      mode_tag="FAC")
        return {"best_bleu4": self.best_bleu4}

    def _state(self, epoch: int) -> CheckpointState:
        return CheckpointState(
            epoch=epoch,
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4,
            params={"decoder": self.dec, "head": self.head},
            opt_states={"optimizer": self.opt_state,
                        "lang_optimizer": self.lang_opt_state})

    def restore(self, path: str) -> None:
        """Full resume: params, BOTH optimizer states, epoch and plateau
        counters (``train_multitask.py:169-177``), each tensor placed as
        this trainer's own."""
        restored = load_checkpoint(path, self._state(0).as_pytree())
        self.dec = restored["params"]["decoder"]
        self.head = restored["params"]["head"]
        self.opt_state = restored["opt_states"]["optimizer"]
        self.lang_opt_state = restored["opt_states"]["lang_optimizer"]
        self.start_epoch = int(restored["epoch"]) + 1
        self.epochs_since_improvement = {
            k: int(v) for k, v in restored["epochs_since_improvement"].items()}
        self.best_bleu4 = {
            k: float(v) for k, v in restored["best_bleu4"].items()}

    def save(self, epoch: int, is_best: bool, mode_tag: Optional[str] = None):
        save_checkpoint(self.model_dir, self.data_name,
                        mode_tag or self.tcfg.mode[:3].upper(),
                        self._state(epoch), is_best)


class TransferTrainer(MultitaskTrainer):
    """T5: stage-2 transfer fine-tune from a factual checkpoint.

    StyleNet: language optimizer masked to style-S tensors + output head
    (``train_transfer.py:94-115``); NIC: masked to the LSTM cell
    (``nic/train_transfer.py:92-96``).  Supervised vs unsupervised is purely
    a data question (paired vs unpaired emotion corpus): same loop.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from icee_tpu_torch.models.factored_lstm import style_param_mask

        if self.factored:
            mask = style_param_mask(self.dec, include_output_head=True)
        else:
            mask = {k: k == "cell" for k in self.dec}
        self.lang_optimizer = optim.make_adam(
            self.tcfg.lr_language, self.tcfg, param_mask=mask)
        self._build_steps()
        self.lang_opt_state = self.lang_optimizer.init(self.dec)

    def train_transfer(self, emotion_loader, val_emotion_loader,
                       num_epochs: Optional[int] = None) -> Dict:
        """Emotion-only fine-tuning loop (``train_transfer.py:128-207``)."""
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        emo = mode_id(tcfg.mode)
        tag = tcfg.mode[:3].upper()
        for epoch in range(self.start_epoch, num_epochs):
            imp = self.epochs_since_improvement["emotion"]
            if imp >= tcfg.early_stop_patience:
                break
            if imp > 0 and imp % tcfg.lr_decay_patience == 0:
                optim.decay_lr(self.lang_opt_state, tcfg.lr_decay_factor)
            tr = self._run_train(emotion_loader, emo, tcfg.log_step_emotion,
                                 tag)
            va = self._run_val(val_emotion_loader, emo)
            _log(self.log_path,
                 f"Epoch [{epoch}/{num_epochs}], [{tag}], "
                 f"Top-5 Acc: {va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                 f"\tTrain Loss: {tr.loss:.4f} | Val Loss: {va.loss:.4f}")
            self.save(epoch, self._improved("emotion", va.bleu4))
        return {"best_bleu4": self.best_bleu4}


class PaperRegimeTrainer(MultitaskTrainer):
    """T1: the StyleNet-paper regime (``stylenet/train.py``): factual pass
    plus *text-only* emotion passes, one Adam per emotion over that
    emotion's S slice (``train.py:135-150``).  Text-only batches carry no
    features (the decoder's ``features=None`` path)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.style_optimizers = {}
        self.style_opt_states = {}
        self.style_steps = {}
        for emo in EMOTIONS:
            tx = optim.make_style_adam(self.tcfg.lr_language, mode_id(emo),
                                       self.tcfg)
            self.style_optimizers[emo] = tx
            self.style_opt_states[emo] = tx.init(self.dec)
            self.style_steps[emo] = TextStyleStep(self.cfg, self.tcfg, tx,
                                                  self.device)

    def train(self, data_loader, style_loaders: Dict[str, object],
              num_epochs: Optional[int] = None) -> None:
        num_epochs = num_epochs or self.tcfg.num_epochs
        for epoch in range(num_epochs):
            self._run_train(data_loader, 0, self.tcfg.log_step, "FAC")
            for emo, loader in style_loaders.items():
                _refuse_device_data(loader)
                sid = mode_id(emo)
                step = self.style_steps[emo]
                for batch in loader:
                    caps, lens, smask = self._to_device(
                        batch.captions, batch.lengths, batch.sample_mask)
                    self.dec, self.style_opt_states[emo], _ = step(
                        self.dec, self.style_opt_states[emo], caps, lens,
                        smask, sid,
                        **self._step_randomness(batch.batch_size,
                                                caps.shape[1]))
            self.save(epoch, is_best=False, mode_tag="PAPER")


class Seq2SeqTrainer:
    """T6 (``seq2seq/train.py``): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the seq2seq trainer comes with slice 6 of the port")
