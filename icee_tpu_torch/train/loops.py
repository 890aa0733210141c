"""Training regimes as host-side epoch drivers over the training steps (port
of ``icee_tpu/train/loops.py``: ``MultitaskTrainer``, ``TransferTrainer``,
``PaperRegimeTrainer`` and ``Seq2SeqTrainer``).

The captioning regimes share the reference's control policy
(``train_multitask.py:180-269``): per-epoch factual track then the
emotion track, teacher-forced training and free-running validation with
loss / perplexity / top-5 / corpus BLEU-4, LR x0.8 after every 4
non-improving epochs of a track, early stop once both tracks reach 10,
best-BLEU checkpointing, and a beam-decoded sample caption printed per
validation.  The JSONL events (``epoch_factual``,
``epoch_emotion``, ``lr_decay``, ``early_stop``) are the JAX package's.

Batches come from :mod:`icee_tpu_torch.data.pipeline` as NumPy; the
trainer moves them to its device (CUDA unless the caller asks for the CPU)
and reads each step's loss, as the JAX loop does.  A split held on the
device (:class:`icee_tpu_torch.data.device.DeviceCaptionData`, pinned or
streamed) instead trains whole epochs there: each batch is gathered on the
device from the epoch's index rows, each step's loss and token count go
into a (2, nb) float64 tensor on the device, and the host reads that
tensor once an epoch (or at each progress record); the same steps run in
the same order with the same randomness, so the parameters equal the host
loop's.
On CUDA the steps launch the hand-written kernels (K3 or K4 on the
teacher-forced global families, K5 on the attention families, the chunked
CE on all) and the default sample one K2 search; on the CPU they run the
kernels' plain versions.

With ``tcfg.progress_chunk > 0`` a device epoch writes a crash-atomic
progress record (:mod:`icee_tpu_torch.checkpoint.progress`) every
``progress_chunk`` batches, and ``train`` / ``train_factual_only`` /
``train_transfer`` resume a killed run from it, bit for bit.

Randomness: a ``torch.Generator`` seeded from ``tcfg.seed`` on the
trainer's device drives the dropout keep-mask and the teacher-forcing
coins.  ``draws(batch, steps) -> (keep, coins)``, when given, is called
once per training step instead (the JAX loop splits its key once per
training step and never on validation), and its results are passed to the
step as ``keep=`` / ``coins=``: this is how the tests hand the port the
JAX package's draws, which torch cannot reproduce.

``Seq2SeqTrainer`` trains seq2seq style transfer on the host loader or
pinned splits.

On a mesh (``mesh=``, :mod:`icee_tpu_torch.parallel`; one process per
card) every rank builds the same global batches from the same seeded
loader or device split and its steps compute on its rows
(``train/steps.py``): the decoder lives as this rank's vocabulary slice
(whole for seq2seq, which is data parallel only), the other trees whole,
all broadcast from rank 0 first.  Validation, the sample caption, the
checkpoints and the progress records use the whole decoder, gathered;
validation sums its loss and top-5 over the ranks' rows and gathers their
predictions, so every rank sees the single-device metrics and takes the
same decisions.  Only rank 0 prints, writes the log, the JSONL metrics, the
checkpoints and the progress records, in the single-device format (the
serving engine loads them unchanged); ``restore`` loads whole, then
shards.  The batch sizes must divide by the data axis.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from icee_tpu_torch.checkpoint import progress
from icee_tpu_torch.checkpoint.ckpt import (CheckpointState, load_checkpoint,
                                            save_checkpoint)
from icee_tpu_torch.core.config import (EMOTIONS, DecoderConfig, TrainConfig,
                                        mode_id)
from icee_tpu_torch.core.device import resolve_indexed_device
from icee_tpu_torch.data.device import (DeviceCaptionData,
                                        StreamedCaptionData, gather_batch)
from icee_tpu_torch.evaluation.bleu import corpus_bleu
from icee_tpu_torch.evaluation.metrics import AverageMeter, perplexity
from icee_tpu_torch.parallel import train as ptrain
from icee_tpu_torch.parallel.data import check_batch_sizes
from icee_tpu_torch.parallel.mesh import decoder_param_shardings
from icee_tpu_torch.train import optim
from icee_tpu_torch.train.steps import (TextStyleStep, make_attention_steps,
                                        make_caption_steps,
                                        make_seq2seq_steps)
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


def _epoch_rows(ddata: DeviceCaptionData, idx, valid, device):
    """An epoch's index rows on ``device``: (example rows, unique-image rows
    or None, sample mask), copied once from page-locked memory."""
    def put(a, dtype):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
        if device.type == "cuda":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    rows = None
    if ddata.images is not None or isinstance(ddata, StreamedCaptionData):
        rows = put(ddata.image_rows(idx), torch.int64)
    return put(idx, torch.int64), rows, put(valid, torch.bool)


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
        self.cfg, self.tcfg, self.vocab = cfg, tcfg, vocab
        self.family = family
        self.attention = family.endswith("_att")
        self.factored = family.startswith("factored")
        self.mesh = mesh
        self.writer = mesh is None or mesh.is_writer
        if mesh is not None:
            check_batch_sizes(tcfg, mesh)
            device = mesh.device
        self.device = resolve_indexed_device(device)
        self.load_params(dec_params, head_params)
        self.sample_fn = sample_fn
        self.log_path = log_path
        self.model_dir = model_dir
        self.data_name = data_name
        self.metrics = MetricsLogger(metrics_path if self.writer else None)
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

    def load_params(self, dec_params, head_params) -> None:
        """Take whole (decoder, head) trees as this trainer's own: copies
        on its device; on a mesh rank 0's, broadcast, the decoder cut to
        this rank's vocabulary slice."""
        dec = _clone(dec_params, self.device)
        self.head = _clone(head_params, self.device)
        if self.mesh is None:
            self.dec = dec
            return
        ptrain.broadcast_params((dec, self.head))
        self.dec_specs = decoder_param_shardings(dec, self.mesh)
        self.dec = ptrain.shard_decoder(dec, self.mesh)

    def _whole_dec(self):
        """The whole decoder (gathered from the ranks' slices on a model
        group of more than one)."""
        if self.mesh is None or self.mesh.n_model == 1:
            return self.dec
        return ptrain.gather_decoder(self.dec, self.mesh, self.dec_specs)

    def _opt_dims(self):
        """The split dimension of each moment of the two optimizers'
        states (the factual one's cover the head too, but the attention
        families')."""
        dims = optim.tree_leaves(self.dec_specs)
        head = [] if self.attention else [None] * len(
            optim.tree_leaves(self.head))
        return dims + head, dims

    def _whole_state(self):
        """-> (decoder, head, optimizer state, language optimizer state),
        whole, on every rank."""
        if self.mesh is None or self.mesh.n_model == 1:
            return self.dec, self.head, self.opt_state, self.lang_opt_state
        fac, lang = self._opt_dims()
        return (self._whole_dec(), self.head,
                ptrain.map_state(ptrain.gather_leaves, self.opt_state, fac,
                                 self.mesh),
                ptrain.map_state(ptrain.gather_leaves, self.lang_opt_state,
                                 lang, self.mesh))

    def _set_whole_state(self, dec, head, opt_state, lang_opt_state) -> None:
        """Take restored whole trees (the same on every rank), cut to this
        rank's slices on a mesh."""
        self.head = head
        if self.mesh is None or self.mesh.n_model == 1:
            self.dec, self.opt_state = dec, opt_state
            self.lang_opt_state = lang_opt_state
            return
        fac, lang = self._opt_dims()
        self.dec = ptrain.shard_decoder(dec, self.mesh)
        self.opt_state = ptrain.map_state(ptrain.shard_leaves, opt_state,
                                          fac, self.mesh)
        self.lang_opt_state = ptrain.map_state(
            ptrain.shard_leaves, lang_opt_state, lang, self.mesh)

    def _log(self, text: str) -> None:
        if self.writer:
            _log(self.log_path, text)

    def _print(self, text) -> None:
        if self.writer:
            print(text)

    def _build_steps(self) -> None:
        make = make_attention_steps if self.attention else make_caption_steps
        self.steps = make(self.cfg, self.tcfg, self.optimizer,
                          self.lang_optimizer, self.factored,
                          device=self.device, mesh=self.mesh)
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

    def _apply_step(self, style: Optional[int], feats, caps, lens, smask):
        """One training step of the factual (style None or 0) or emotion
        track on device tensors, the trees updated in place -> the loss (a
        device tensor)."""
        kw = self._step_randomness(caps.shape[0],
                                   caps.shape[1] - int(self.attention))
        if style is None or style == 0:
            if self.attention:
                self.dec, self.opt_state, loss = self.factual_step(
                    self.dec, self.opt_state, feats, caps, lens, smask, **kw)
            else:
                self.dec, self.head, self.opt_state, loss = \
                    self.factual_step(self.dec, self.head, self.opt_state,
                                      feats, caps, lens, smask, **kw)
        elif self.attention:
            self.dec, self.lang_opt_state, loss = self.emotion_step(
                self.dec, self.lang_opt_state, feats, caps, lens, smask,
                style, **kw)
        else:
            self.dec, self.head, self.lang_opt_state, loss = \
                self.emotion_step(self.dec, self.head, self.lang_opt_state,
                                  feats, caps, lens, smask, style, **kw)
        return loss

    def _run_train(self, loader, style: Optional[int], log_step: int,
                   tag: str, epoch: Optional[int] = None, pass_idx: int = 0,
                   start_row: int = 0, loss_prefix=None) -> EpochStats:
        if isinstance(loader, DeviceCaptionData):
            return self._run_train_device(
                loader, style, log_step, tag, epoch=epoch, pass_idx=pass_idx,
                start_row=start_row, loss_prefix=loss_prefix)
        losses = AverageMeter()
        t0 = time.time()
        for i, batch in enumerate(loader):
            feats, caps, lens, smask = self._to_device(
                batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            loss = float(self._apply_step(style, feats, caps, lens, smask))
            if i % log_step == 0:
                self._print(f"Step [{i}/{len(loader)}], [{tag}], "
                            f"Loss: {loss:.4f}")
            losses.update(loss, int(batch.lengths.sum()))
        return EpochStats(loss=losses.avg, batch_time=time.time() - t0)

    @staticmethod
    def _segments(ddata, img_rows, start_row: int, nb: int):
        """(r0, r1, features, image rows) over the epoch's rows from
        ``start_row``: one segment of the pinned features, or a streamed
        split's chunks with their buffers and remaps."""
        if not isinstance(ddata, StreamedCaptionData):
            yield start_row, nb, ddata.images, None
            return
        R = ddata.rows_per_chunk
        bounds = [(r0, min(r0 + R, nb)) for r0 in range(start_row, nb, R)]
        for c, (buf, remap) in enumerate(ddata.stream(img_rows, bounds)):
            yield bounds[c] + (buf, remap)

    def _init_loss_trace(self, nb: int, start_row: int, loss_prefix):
        """The (2, nb) float64 trace of an epoch's losses (row 0) and token
        counts (row 1) on the device, a resumed prefix restored."""
        trace = torch.zeros((2, nb), dtype=torch.float64, device=self.device)
        if loss_prefix is not None:
            trace[:, :start_row] = torch.as_tensor(np.stack(
                [np.asarray(p, np.float64)[:start_row] for p in loss_prefix]))
        return trace

    def _epoch_stats(self, trace, log_step, tag, t0) -> EpochStats:
        """Step logging after the epoch + the token-weighted epoch loss of
        a host (2, nb) trace, summed in the host loop's order (the same
        float as its meter)."""
        meter = AverageMeter()
        losses, ntoks = trace.tolist()
        for i, (loss, n) in enumerate(zip(losses, ntoks)):
            if i % max(log_step, 1) == 0:
                self._print(f"Step [{i}/{len(losses)}], [{tag}], "
                            f"Loss: {loss:.4f}")
            meter.update(loss, int(n))
        return EpochStats(loss=meter.avg, batch_time=time.time() - t0)

    def _run_train_device(self, ddata, style: Optional[int], log_step: int,
                          tag: str, epoch: Optional[int] = None,
                          pass_idx: int = 0, start_row: int = 0,
                          loss_prefix=None) -> EpochStats:
        """One training epoch over a :class:`DeviceCaptionData` (pinned) or
        :class:`StreamedCaptionData` split: the host loop's steps in its
        order, each batch gathered on the device.  No step's loss is read
        until the epoch ends, except at a progress record: with
        ``tcfg.progress_chunk > 0`` (and an ``epoch`` to label it) one is
        written after every ``progress_chunk`` rows and the last.
        ``start_row`` / ``loss_prefix`` restart a killed pass at its last
        record."""
        t0 = time.time()
        idx, valid = ddata.epoch_indices()
        nb = idx.shape[0]
        idx_d, rows_d, valid_d = _epoch_rows(ddata, idx, valid, self.device)
        img_rows = ddata.image_rows(idx)
        trace = self._init_loss_trace(nb, start_row, loss_prefix)
        chunk = self.tcfg.progress_chunk if epoch is not None else 0
        last_saved = start_row
        for r0, r1, images, remap in self._segments(ddata, img_rows,
                                                    start_row, nb):
            for r in range(r0, r1):
                b_img = rows_d[r] if remap is None else remap[r - r0]
                feats, caps, lens = gather_batch(
                    images, ddata.captions, ddata.lengths, idx_d[r], b_img,
                    valid_d[r])
                trace[0, r] = self._apply_step(style, feats, caps, lens,
                                               valid_d[r])
                trace[1, r] = lens.sum()
                if chunk and (r + 1 - last_saved >= chunk or r + 1 == nb):
                    last_saved = r + 1
                    self._save_progress(epoch, pass_idx, r + 1,
                                        *trace.cpu().numpy())
        return self._epoch_stats(trace.cpu(), log_step, tag, t0)

    # -- mid-epoch progress (checkpoint/progress.py) ------------------------

    def _save_progress(self, epoch: int, pass_idx: int, row: int,
                       losses, ntoks) -> None:
        dec, head, opt, lang = self._whole_state()
        record = progress.make_record(
            epoch=epoch, pass_idx=pass_idx, row=row,
            rng=self.generator.get_state(),
            params={"decoder": dec, "head": head},
            opt_states={"optimizer": opt, "lang_optimizer": lang},
            losses=losses, ntoks=ntoks,
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4)
        if self.writer:
            progress.save_progress(self.model_dir, self.data_name, record)
        if self.mesh is not None:
            torch.distributed.barrier()
        hook = getattr(self, "_progress_hook", None)
        if hook is not None:
            hook(epoch, pass_idx, row)

    def _clear_progress(self) -> None:
        """Drop the mid-epoch record once a train loop runs to completion:
        a later fresh run in the same model_dir must not resume past it."""
        if self.tcfg.progress_chunk and self.writer:
            progress.clear_progress(self.model_dir, self.data_name)

    def _resume_progress(self, loaders_by_pass: dict) -> Optional[dict]:
        """If a progress record exists, restore the whole training state
        from it and return ``{"epoch", "pass_idx", "row", "losses",
        "ntoks"}``.

        ``loaders_by_pass`` maps pass_idx -> that pass's TRAIN loader;
        every shuffling device split is fast-forwarded one
        ``epoch_indices()`` call a COMPLETED epoch, so the resumed epoch's
        shuffle is the killed run's."""
        dec, head, opt, lang = self._whole_state()
        rec = progress.load_progress(
            self.model_dir, self.data_name,
            {"params": {"decoder": dec, "head": head},
             "opt_states": {"optimizer": opt, "lang_optimizer": lang}})
        if rec is None:
            return None
        epoch, pass_idx, row = rec["epoch"], rec["pass_idx"], rec["row"]
        self._set_whole_state(rec["params"]["decoder"],
                              rec["params"]["head"],
                              rec["opt_states"]["optimizer"],
                              rec["opt_states"]["lang_optimizer"])
        self.generator.set_state(rec["rng"])
        self.epochs_since_improvement = dict(rec["epochs_since_improvement"])
        self.best_bleu4 = dict(rec["best_bleu4"])
        self.start_epoch = epoch
        for _ in range(epoch):           # completed epochs
            for ld in loaders_by_pass.values():
                if isinstance(ld, DeviceCaptionData) and ld.shuffle:
                    ld.epoch_indices()
        nb = len(rec["losses"])
        self._log(f"RESUMING mid-epoch: epoch {epoch}, pass "
                  f"{pass_idx}, row {row}/{nb}")
        return {"epoch": epoch, "pass_idx": pass_idx, "row": row,
                "losses": rec["losses"], "ntoks": rec["ntoks"]}

    # -- validation -------------------------------------------------------

    def _val_batch(self, dec, feats, caps, lens, smask, style: int):
        return self.val_step(
            dec, *(() if self.attention else (self.head,)),
            feats, caps, lens, smask, style)

    def _run_val(self, loader, style: int) -> EpochStats:
        dec = self._whole_dec()
        if isinstance(loader, DeviceCaptionData):
            return self._run_val_device(loader, style, dec)
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
            loss, top5, preds = self._val_batch(dec, feats, caps, lens,
                                                smask, style)
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
            self._print(self.sample_fn(dec, self.head, last_feat[0:1], style))
        return EpochStats(loss=losses.avg, top5=top5s.avg, bleu4=bleu4,
                          batch_time=time.time() - t0)

    def _run_val_device(self, ddata, style: int, dec) -> EpochStats:
        """Validation over a :class:`DeviceCaptionData` or
        :class:`StreamedCaptionData` split: the host ``_run_val``'s batches
        and metrics, each batch gathered on the device and the results read
        once at the end."""
        t0 = time.time()
        idx, valid = ddata.epoch_indices()
        nb = idx.shape[0]
        idx_d, rows_d, valid_d = _epoch_rows(ddata, idx, valid, self.device)
        img_rows = ddata.image_rows(idx)
        outs, lens_all = [], []
        for r0, r1, images, remap in self._segments(ddata, img_rows, 0, nb):
            for r in range(r0, r1):
                b_img = rows_d[r] if remap is None else remap[r - r0]
                feats, caps, lens = gather_batch(
                    images, ddata.captions, ddata.lengths, idx_d[r], b_img,
                    valid_d[r])
                outs.append(self._val_batch(dec, feats, caps, lens,
                                            valid_d[r], style))
                lens_all.append(lens)
        loss_t = torch.stack([o[0] for o in outs]).cpu().tolist()
        top5_t = torch.stack([o[1] for o in outs]).cpu().tolist()
        preds = torch.stack([o[2] for o in outs]).cpu().numpy()
        lens_h = torch.stack(lens_all).cpu().numpy()
        losses, top5s = AverageMeter(), AverageMeter()
        references, hypotheses = [], []
        start, end = self.vocab.start, self.vocab.end
        shift = 1 if self.attention else 0
        for b in range(nb):
            n_tok = int(lens_h[b].sum())
            losses.update(loss_t[b], n_tok)
            top5s.update(top5_t[b], n_tok)
            for j in range(idx.shape[1]):
                if not valid[b, j]:
                    continue
                references.append([strip_specials(r, start, end)
                                   for r in ddata.references[int(idx[b, j])]])
                L = max(int(lens_h[b, j]) - shift, 0)
                hypotheses.append(
                    strip_specials(preds[b, j, :L].tolist(), start, end))
        bleu4 = corpus_bleu(references, hypotheses)
        if self.sample_fn is not None and nb:
            # the host loop samples from the first row of the last batch
            feat = ddata.sample_feature(int(img_rows[-1, 0]))
            self._print(self.sample_fn(dec, self.head, feat, style))
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

    @staticmethod
    def _resume_kw(prog: Optional[dict]) -> dict:
        """``_run_train``'s restart arguments for the in-flight pass."""
        if prog is None:
            return {}
        return dict(start_row=prog["row"],
                    loss_prefix=(prog["losses"], prog["ntoks"]))

    def train(self, data_loader, val_loader, emotion_loader,
              val_emotion_loader, num_epochs: Optional[int] = None) -> Dict:
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        emo = mode_id(tcfg.mode)
        tag = tcfg.mode[:3].upper()
        prog = None
        if tcfg.progress_chunk:
            prog = self._resume_progress({0: data_loader, 1: emotion_loader})
        for epoch in range(self.start_epoch, num_epochs):
            # mid-epoch resume: the passes before prog["pass_idx"] ran (their
            # validation too: the record's counters include it) and the
            # in-flight pass restarts at prog["row"].  The epoch-start
            # decay/early-stop block ran in the killed run (its effect is in
            # the record's optimizer states), so it does not run again.
            resuming = prog is not None and prog["epoch"] == epoch
            if not resuming:
                imp_fac = self.epochs_since_improvement["factual"]
                imp_emo = self.epochs_since_improvement["emotion"]
                if imp_fac >= tcfg.early_stop_patience and \
                        imp_emo >= tcfg.early_stop_patience:
                    self.metrics.log("early_stop", epoch=epoch,
                                     imp_fac=imp_fac, imp_emo=imp_emo)
                    break
                if imp_fac > 0 and imp_fac % tcfg.lr_decay_patience == 0:
                    lr = optim.decay_lr(self.opt_state, tcfg.lr_decay_factor)
                    self._log(f"DECAYING learning rate to {lr:f}")
                    self.metrics.log("lr_decay", epoch=epoch,
                                     track="factual", lr=lr)
                if imp_emo > 0 and imp_emo % tcfg.lr_decay_patience == 0:
                    lr = optim.decay_lr(self.lang_opt_state,
                                        tcfg.lr_decay_factor)
                    self._log(
                        f"DECAYING language learning rate to {lr:f}")
                    self.metrics.log("lr_decay", epoch=epoch,
                                     track="emotion", lr=lr)

            # factual track
            if resuming and prog["pass_idx"] > 0:
                # complete (validated, counted): burn its shuffle draw so
                # later epochs' batches are the killed run's
                if isinstance(data_loader, DeviceCaptionData) and \
                        data_loader.shuffle:
                    data_loader.epoch_indices()
                self._log(
                    f"Epoch [{epoch}/{num_epochs}], [FAC], resumed past "
                    "(completed before preemption)")
            else:
                tr = self._run_train(
                    data_loader, 0, tcfg.log_step, "FAC", epoch=epoch,
                    pass_idx=0, **self._resume_kw(prog if resuming else None))
                va = self._run_val(val_loader, 0)
                self._log(
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
            emo_kw = self._resume_kw(
                prog if resuming and prog["pass_idx"] == 1 else None)
            if resuming:
                prog = None            # consumed; later epochs run normally
            tr_e = self._run_train(emotion_loader, emo, tcfg.log_step_emotion,
                                   tag, epoch=epoch, pass_idx=1, **emo_kw)
            va_e = self._run_val(val_emotion_loader, emo)
            self._log(
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
        self._clear_progress()
        return {"best_bleu4": self.best_bleu4}

    def train_factual_only(self, data_loader, val_loader,
                           num_epochs: Optional[int] = None) -> Dict:
        """T4: stage-1 factual pretraining (``train_transfer_fac.py:83-160``);
        produces the FAC_BEST checkpoint the transfer stage resumes from."""
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.num_epochs
        prog = None
        if tcfg.progress_chunk:
            prog = self._resume_progress({0: data_loader})
        for epoch in range(self.start_epoch, num_epochs):
            resuming = prog is not None and prog["epoch"] == epoch
            fac_kw = self._resume_kw(prog if resuming else None)
            if resuming:
                prog = None
            else:
                imp = self.epochs_since_improvement["factual"]
                if imp >= tcfg.early_stop_patience:
                    break
                if imp > 0 and imp % tcfg.lr_decay_patience == 0:
                    optim.decay_lr(self.opt_state, tcfg.lr_decay_factor)
            tr = self._run_train(data_loader, 0, tcfg.log_step, "FAC",
                                 epoch=epoch, pass_idx=0, **fac_kw)
            va = self._run_val(val_loader, 0)
            self._log(
                f"Epoch [{epoch}/{num_epochs}], [FAC], Top-5 Acc: "
                f"{va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                f"\tTrain Loss: {tr.loss:.4f} | Val Loss: {va.loss:.4f}")
            self.save(epoch, self._improved("factual", va.bleu4),
                      mode_tag="FAC")
        self._clear_progress()
        return {"best_bleu4": self.best_bleu4}

    def _state(self, epoch: int) -> CheckpointState:
        """The whole trees' checkpoint state (gathered on a mesh)."""
        dec, head, opt, lang = self._whole_state()
        return CheckpointState(
            epoch=epoch,
            epochs_since_improvement=self.epochs_since_improvement,
            best_bleu4=self.best_bleu4,
            params={"decoder": dec, "head": head},
            opt_states={"optimizer": opt, "lang_optimizer": lang})

    def restore(self, path: str) -> None:
        """Full resume: params, BOTH optimizer states, epoch and plateau
        counters (``train_multitask.py:169-177``), each tensor placed as
        this trainer's own (on a mesh: loaded whole, then sharded)."""
        restored = load_checkpoint(path, self._state(0).as_pytree())
        self._set_whole_state(restored["params"]["decoder"],
                              restored["params"]["head"],
                              restored["opt_states"]["optimizer"],
                              restored["opt_states"]["lang_optimizer"])
        self.start_epoch = int(restored["epoch"]) + 1
        self.epochs_since_improvement = {
            k: int(v) for k, v in restored["epochs_since_improvement"].items()}
        self.best_bleu4 = {
            k: float(v) for k, v in restored["best_bleu4"].items()}

    def save(self, epoch: int, is_best: bool, mode_tag: Optional[str] = None):
        """Rank 0 writes the checkpoint (every rank gathers)."""
        state = self._state(epoch)
        if self.writer:
            save_checkpoint(self.model_dir, self.data_name,
                            mode_tag or self.tcfg.mode[:3].upper(), state,
                            is_best)
        if self.mesh is not None:
            torch.distributed.barrier()


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
        prog = None
        if tcfg.progress_chunk:
            prog = self._resume_progress({0: emotion_loader})
        for epoch in range(self.start_epoch, num_epochs):
            resuming = prog is not None and prog["epoch"] == epoch
            emo_kw = self._resume_kw(prog if resuming else None)
            if resuming:
                prog = None
            else:
                imp = self.epochs_since_improvement["emotion"]
                if imp >= tcfg.early_stop_patience:
                    break
                if imp > 0 and imp % tcfg.lr_decay_patience == 0:
                    optim.decay_lr(self.lang_opt_state, tcfg.lr_decay_factor)
            tr = self._run_train(emotion_loader, emo, tcfg.log_step_emotion,
                                 tag, epoch=epoch, pass_idx=0, **emo_kw)
            va = self._run_val(val_emotion_loader, emo)
            self._log(
                f"Epoch [{epoch}/{num_epochs}], [{tag}], "
                f"Top-5 Acc: {va.top5:.3f}, BLEU-4 Score: {va.bleu4}\n"
                f"\tTrain Loss: {tr.loss:.4f} | Val Loss: {va.loss:.4f}")
            self.save(epoch, self._improved("emotion", va.bleu4))
        self._clear_progress()
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
                                                  self.device, self.mesh)

    def _style_step(self, emo: str, caps, lens, smask) -> None:
        self.dec, self.style_opt_states[emo], _ = self.style_steps[emo](
            self.dec, self.style_opt_states[emo], caps, lens, smask,
            mode_id(emo), **self._step_randomness(caps.shape[0],
                                                  caps.shape[1]))

    def _style_epoch(self, emo: str, ddata: DeviceCaptionData) -> None:
        """One text-only style epoch over a corpus on the device
        (``data/device.py::from_styled``): the host loop's steps in its
        order, each batch gathered on the device; no loss is read."""
        idx, valid = ddata.epoch_indices()
        idx_d, _, valid_d = _epoch_rows(ddata, idx, valid, self.device)
        for r in range(idx.shape[0]):
            _, caps, lens = gather_batch(None, ddata.captions, ddata.lengths,
                                         idx_d[r], None, valid_d[r])
            self._style_step(emo, caps, lens, valid_d[r])

    def train(self, data_loader, style_loaders: Dict[str, object],
              num_epochs: Optional[int] = None) -> None:
        num_epochs = num_epochs or self.tcfg.num_epochs
        for epoch in range(num_epochs):
            self._run_train(data_loader, 0, self.tcfg.log_step, "FAC")
            for emo, loader in style_loaders.items():
                if isinstance(loader, DeviceCaptionData):
                    self._style_epoch(emo, loader)
                    continue
                for batch in loader:
                    caps, lens, smask = self._to_device(
                        batch.captions, batch.lengths, batch.sample_mask)
                    self._style_step(emo, caps, lens, smask)
            self.save(epoch, is_best=False, mode_tag="PAPER")


class Seq2SeqTrainer:
    """T6 (``seq2seq/train.py``): factual autoencode pass + per-emotion
    decoder passes (port of ``icee_tpu/train/loops.py::Seq2SeqTrainer``).
    Reference quirk kept: the emotion pass feeds the *factual* caption as
    both source and target (``seq2seq/train.py:316-317``), so loaders only
    need (image, src).

    ``params`` (:mod:`icee_tpu_torch.models.seq2seq`) and ``head`` are
    copied to ``device``; the trainer updates its copies in place.  A split
    on the device (:class:`icee_tpu_torch.data.device.DeviceCaptionData`,
    pinned) trains and validates there: each batch gathered on the device,
    every step's loss and token count kept there and read once a pass; the
    same steps in the same order with the same randomness as the host
    loader's, so the parameters equal its bit for bit.  A streamed split is
    refused (the train CLI takes the host loader for one, as JAX's does).
    ``draws(batch, steps, track) -> (keep, coins)`` with ``track``
    ``"factual"`` or ``"emotion"``, when given, replaces the generator once
    a training step (as in :class:`MultitaskTrainer`).  No checkpoint is
    written, as in the JAX trainer."""

    def __init__(self, cfg, tcfg: TrainConfig, vocab, params, head,
                 log_path: Optional[str] = None, mesh=None, device="cuda",
                 draws: Optional[Callable] = None):
        self.cfg, self.tcfg, self.vocab = cfg, tcfg, vocab
        self.mesh = mesh
        self.writer = mesh is None or mesh.is_writer
        if mesh is not None:
            check_batch_sizes(tcfg, mesh)
            device = mesh.device
        self.device = resolve_indexed_device(device)
        self.params = _clone(params, self.device)
        self.head = _clone(head, self.device)
        if mesh is not None:
            ptrain.broadcast_params((self.params, self.head))
        self.log_path = log_path
        self.generator = torch.Generator(device=self.device).manual_seed(
            tcfg.seed)
        self.draws = draws
        self.optimizer = optim.make_adam(tcfg.lr_caption, tcfg)
        self.emotion_optimizer = optim.make_adam(tcfg.lr_language, tcfg)
        self.steps = make_seq2seq_steps(cfg, tcfg, self.optimizer,
                                        self.emotion_optimizer, self.device,
                                        mesh)
        (self.factual_step, self.emotion_step, self.val_factual,
         self.val_emotion) = self.steps
        self.opt_state = self.optimizer.init((self.params["encoder"],
                                              self.head))
        self.emotion_opt_state = self.emotion_optimizer.init(
            self.params["decoders"])

    _to_device = MultitaskTrainer._to_device
    _log = MultitaskTrainer._log

    def _step_randomness(self, batch: int, steps: int, track: str) -> dict:
        if self.draws is None:
            return {"generator": self.generator}
        keep, coins = self.draws(batch, steps, track)
        return {"keep": keep, "coins": coins}

    def _factual(self, feats, caps, lens, smask):
        """One factual step in place -> its loss (a device tensor)."""
        kw = self._step_randomness(caps.shape[0], caps.shape[1], "factual")
        self.params, self.head, self.opt_state, loss = self.factual_step(
            self.params, self.head, self.opt_state, feats, caps, lens, smask,
            **kw)
        return loss

    def _emotion(self, eid: int, feats, caps, lens, smask):
        """One emotion step, dst = src (``seq2seq/train.py:316-317``)."""
        kw = self._step_randomness(caps.shape[0], caps.shape[1] - 1,
                                   "emotion")
        self.params, self.emotion_opt_state, loss = self.emotion_step(
            self.params, self.head, self.emotion_opt_state, feats, caps,
            lens, caps, lens, smask, eid, **kw)
        return loss

    def _device_pass(self, ddata: DeviceCaptionData, fn) -> list:
        """``fn(feats, caps, lens, valid)`` once a batch of a pinned split's
        epoch, in order, each batch gathered on the device -> the results,
        nothing read."""
        if isinstance(ddata, StreamedCaptionData):
            raise ValueError("Seq2SeqTrainer trains pinned splits or the "
                             "host loader, not a streamed split")
        idx, valid = ddata.epoch_indices()
        idx_d, rows_d, valid_d = _epoch_rows(ddata, idx, valid, self.device)
        out = []
        for r in range(idx.shape[0]):
            feats, caps, lens = gather_batch(
                ddata.images, ddata.captions, ddata.lengths, idx_d[r],
                rows_d[r], valid_d[r])
            out.append(fn(feats, caps, lens, valid_d[r]))
        return out

    def _train_pass(self, loader, step) -> AverageMeter:
        """One training pass of ``step(feats, caps, lens, smask) -> loss``
        -> the token-weighted loss meter (token counts: the lengths)."""
        meter = AverageMeter()
        if isinstance(loader, DeviceCaptionData):
            out = self._device_pass(loader, lambda f, c, ln, v: torch.stack(
                [step(f, c, ln, v).double(), ln.sum().double()]))
            if out:
                for loss, n in torch.stack(out).cpu().tolist():
                    meter.update(loss, int(n))
            return meter
        for batch in loader:
            feats, caps, lens, smask = self._to_device(
                batch.images, batch.captions, batch.lengths,
                batch.sample_mask)
            meter.update(float(step(feats, caps, lens, smask)),
                         int(batch.lengths.sum()))
        return meter

    def train(self, data_loader, emotion_loaders: Dict[str, object],
              num_epochs: Optional[int] = None, val_loader=None,
              val_emotion_loaders: Optional[Dict] = None) -> None:
        num_epochs = num_epochs or self.tcfg.num_epochs
        for epoch in range(num_epochs):
            losses = self._train_pass(data_loader, self._factual)
            self._log(
                f"Epoch [{epoch}/{num_epochs}], [FAC], "
                f"Loss {losses.avg:.4f}")
            if val_loader is not None:
                vl, vt = self.validate_factual(val_loader)
                self._log(
                    f"\tVal Loss: {vl:.4f} | Perplexity "
                    f"{perplexity(vl):.4f} | Top-5 {vt:.3f}")
            for emo, loader in emotion_loaders.items():
                eid = mode_id(emo) - 1
                e_losses = self._train_pass(
                    loader, lambda f, c, ln, v, e=eid: self._emotion(
                        e, f, c, ln, v))
                self._log(
                    f"Epoch [{epoch}/{num_epochs}], "
                    f"[{emo[:3].upper()}], Loss {e_losses.avg:.4f}")
                if val_emotion_loaders and emo in val_emotion_loaders:
                    vl, vt = self.validate_emotion(
                        val_emotion_loaders[emo], eid)
                    self._log(
                        f"\tVal Loss: {vl:.4f} | Top-5 {vt:.3f}")

    def _validate(self, loader, fn, tokens) -> tuple:
        """Token-weighted (loss, top-5) of ``fn(feats, caps, lens, smask)
        -> (loss, top5, preds)`` over a split; ``tokens(lengths)`` is a
        batch's weight."""
        losses, top5s = AverageMeter(), AverageMeter()
        if isinstance(loader, DeviceCaptionData):
            out = self._device_pass(loader, lambda f, c, ln, v: torch.stack(
                [*(x.double() for x in fn(f, c, ln, v)[:2]),
                 tokens(ln).double()]))
            rows = torch.stack(out).cpu().tolist() if out else []
        else:
            rows = []
            for batch in loader:
                feats, caps, lens, smask = self._to_device(
                    batch.images, batch.captions, batch.lengths,
                    batch.sample_mask)
                loss, top5, _ = fn(feats, caps, lens, smask)
                rows.append((float(loss), float(top5),
                             tokens(torch.from_numpy(batch.lengths))))
        for loss, top5, n in rows:
            losses.update(loss, int(n))
            top5s.update(top5, int(n))
        return losses.avg, top5s.avg

    def validate_factual(self, loader):
        """seq2seq ``val_factual`` (``seq2seq/train.py:262-299``): teacher-
        forcing off, token-mean loss + top-5."""
        return self._validate(
            loader, lambda f, c, ln, v: self.val_factual(
                self.params, self.head, f, c, ln, v),
            lambda ln: ln.sum())

    def validate_emotion(self, loader, emotion_id: int):
        """seq2seq ``val_emotion`` (``seq2seq/train.py:303-345``), with the
        dst=src overwrite kept; a batch weighs its lengths - 1 (at least
        1)."""
        return self._validate(
            loader, lambda f, c, ln, v: self.val_emotion(
                self.params, self.head, f, c, ln, c, ln, v, emotion_id),
            lambda ln: (ln - 1).clamp(min=0).sum().clamp(min=1))
