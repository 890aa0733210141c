"""SentiCap training and test entry points (port of
``icee_tpu/senticap/train.py``; reference ``train_mscoco.py`` and
``train_joint.py``).

The reference compiles a Theano ``train(indx)`` whose minibatch gather
happens on the device from shared arrays (``mrnn.py:570-677``); here the
split lives on the device (``io.device_dataset``) and one step gathers rows
by an index vector, runs the forward, the loss and the regularizers, the
gradient, then the reference's RMSProp/Adadelta pipeline.

``train_base`` is the COCO base-model regime (``train_mscoco.py:1-59``);
``train_switched`` the switch ("gap filler") regime: seed both paths of the
switched model from a base model and optimize ONLY the switch set with the
LAMBDA_N/LAMBDA_GAM loss (``train_joint.py:322-451``).
``make_base_epoch`` / ``make_switched_epoch`` run a whole epoch of either
step with one read of its losses, and both regimes train through them.
``validation_perplexity`` and ``decode_split`` evaluate and decode either.
On CUDA the teacher-forced scans run K8 (``ops/senticap_scan.py``), the
losses the chunked CE kernels (the mixture CE for the switched model), and
``decode_split`` the whole beam searches: K9 (``ops/senticap_decode.py``)
for the base model and the switched model's descriptive decode, K10
(``ops/senticap_switched_decode.py``) for its styled decode.

On a mesh (``mesh=``, :mod:`icee_tpu_torch.parallel`; data parallel, as
the JAX package's) every rank holds the whole split and the whole
parameters, draws the GLOBAL minibatch's dropout masks (and semi-forced
matrix) from the same generator state and computes on its data rank's rows
of the minibatch: K8 and the (mixture) CE run per rank.  The loss is a
masked SUM, so the ranks' gradients are SUMMED over the data group, and
the parameter-only regularizers (L2, the similarity term) enter each
rank's cost divided by the data axis so the sum counts them once, as JAX's
``_shard_mapped_grads``.  Only rank 0 prints.

Entry points run on CUDA unless the caller asks for the CPU; parameters are
updated IN PLACE.  Randomness (dropout masks, the semi-forced matrix) comes
from a ``torch.Generator``, or is passed in (``x_drop``, ``y_drop``,
``forced``) as the parity tests do with the JAX package's draws.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from icee_tpu_torch.core.device import resolve_indexed_device
from icee_tpu_torch.parallel.collectives import all_reduce_grads, reduced
from icee_tpu_torch.parallel.data import local_rows, row_slice
from icee_tpu_torch.parallel.train import broadcast_params
from icee_tpu_torch.senticap import io as sio
from icee_tpu_torch.senticap import model as base_model
from icee_tpu_torch.senticap import switched as sw_model
from icee_tpu_torch.senticap.config import DA_SUM, senticap_conf
from icee_tpu_torch.senticap.solver import make_solver

BASE_KEYS = sw_model.BASE_NAMES


def _check_on(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")


def _epoch_indices(n: int, batch: int, rng: np.random.Generator):
    idx = rng.permutation(n)
    n_batches = n // batch
    return idx[: n_batches * batch].reshape(n_batches, batch)


def _epoch_indices_by_sentiment(senti: np.ndarray, batch: int,
                                rng: np.random.Generator):
    """Sentiment-homogeneous minibatches in random order.

    The switched model's recurrence branches on the BATCH-level sentiment
    ``senti[0]`` (``mrnn_switched.py:860-884``), which is only meaningful
    when a batch is sentiment-pure; the reference gets this by slicing
    contiguous dataset blocks.  Shuffle WITHIN each sentiment group and
    interleave the groups' batches randomly (the JAX package's numpy code:
    the same ``rng`` gives the same batches)."""
    batches = []
    for value in np.unique(senti):
        group = np.flatnonzero(senti == value)
        rng.shuffle(group)
        n_batches = len(group) // batch
        for b in range(n_batches):
            batches.append(group[b * batch:(b + 1) * batch])
    order = rng.permutation(len(batches))
    return [batches[i] for i in order]


def _dropout(generator, shape, frac: float, device) -> torch.Tensor:
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - frac
    return keep.to(torch.float32) / (1.0 - frac)


class BaseStep:
    """One base-model step over a device-resident split (see
    :func:`make_base_step`)."""

    def __init__(self, conf: dict, solver, device, mesh=None):
        self.conf, self.solver = conf, solver
        self.mesh = mesh
        self.group = None if mesh is None else mesh.data_group
        self.ndata = 1 if mesh is None else mesh.n_data
        self.device = resolve_indexed_device(
            device if mesh is None else mesh.device)
        self.use_chunked = (base_model.chunked_ce_requested(conf, self.device)
                            and conf.get("SOFTMAX_OUT", True))

    def _local(self, *xs):
        """This data rank's rows of the global minibatch's tensors."""
        return local_rows(xs, self.mesh)

    def _shared(self, loss, grads):
        """The data group's sums of the ranks' loss and gradients."""
        return reduced(loss.detach(), self.group), all_reduce_grads(
            grads, self.group)

    def _dropouts(self, b, t, generator, x_drop, y_drop):
        conf, dev = self.conf, self.device
        if x_drop is None:
            x_drop = _dropout(generator, (b, t, conf["emb_size"]),
                              conf["DROP_INPUT_FRACTION"], dev)
        if y_drop is None:
            y_drop = _dropout(generator, (b, t, conf["lstm_hidden_size"]),
                              conf["DROP_OUTPUT_FRACTION"], dev)
        return x_drop, y_drop

    def _masks(self, b, t, generator, x_drop, y_drop, forced):
        conf, dev = self.conf, self.device
        x_drop, y_drop = self._dropouts(b, t, generator, x_drop, y_drop)
        semi = float(conf.get("SEMI_FORCED", 1.0))
        if forced is None and semi < 1.0:
            # per-(sample, step) Bernoulli(SEMI_FORCED) (mrnn.py:496-503)
            forced = (torch.rand((b, t), generator=generator, device=dev)
                      < semi).to(torch.float32)
        return x_drop, y_drop, forced

    def grads(self, params: dict, data: dict, idx: torch.Tensor,
              generator: Optional[torch.Generator] = None, x_drop=None,
              y_drop=None, forced=None):
        """-> (data loss, grads by name) for the minibatch ``idx``."""
        conf = self.conf
        _check_on(self.device, idx=idx, **{k: params[k] for k in params},
                  **{f"data[{k!r}]": v for k, v in data.items()})
        b, t = idx.shape[0], data["X"].shape[1]
        x_drop, y_drop, forced = self._masks(b, t, generator, x_drop, y_drop,
                                             forced)
        idx, x_drop, y_drop, forced = self._local(idx, x_drop, y_drop,
                                                  forced)
        x, y = data["X"][idx], data["Y"][idx]
        mask, v = data["Xlen"][idx], data["V"][idx]
        semi = float(conf.get("SEMI_FORCED", 1.0))
        with torch.enable_grad():
            p = {k: q.detach().requires_grad_(True) for k, q in params.items()}
            if semi < 1.0:
                out = base_model.forward_semi_forced(
                    p, conf, x, v, forced, x_drop, y_drop,
                    return_hiddens=self.use_chunked)
            else:
                out = base_model.forward(p, conf, x, v, True, x_drop, y_drop,
                                         return_hiddens=self.use_chunked)
            if self.use_chunked:
                loss = base_model.loss_fn_from_hiddens(p, out, y, mask)
            else:
                loss = base_model.loss_fn(out, y, mask)
            l2 = sum(torch.sum(q ** 2) for q in p.values())
            reg = conf["L2_REG_CONST"] * l2
            cost = loss + (reg if self.ndata == 1 else reg / self.ndata)
            got = torch.autograd.grad(cost, list(p.values()))
        return self._shared(loss, dict(zip(p, got)))

    def __call__(self, params: dict, opt_state: dict, data: dict,
                 idx: torch.Tensor,
                 generator: Optional[torch.Generator] = None, **masks):
        """-> (params, opt_state, loss), ``params`` updated in place;
        ``masks`` are :meth:`grads`' injected draws."""
        loss, grads = self.grads(params, data, idx, generator, **masks)
        opt_state = self.solver.update(grads, opt_state, params)
        return params, opt_state, loss


class SwitchedStep(BaseStep):
    """One switched-model step over a device-resident split (see
    :func:`make_switched_step`).  Gradients are taken for the solver's
    trainable leaves only (the switch set under ``train_switched``); the
    L2 term covers the switch set, as the JAX step's ``cost_fn`` does."""

    def __init__(self, conf: dict, solver, device, mesh=None):
        super().__init__(conf, solver, device, mesh)
        # the switched heads are always softmaxes: no SOFTMAX_OUT guard
        self.use_chunked = base_model.chunked_ce_requested(conf, self.device)

    def grads(self, params: dict, data: dict, idx: torch.Tensor,
              generator: Optional[torch.Generator] = None, x_drop=None,
              y_drop=None):
        """-> (data loss, grads by trainable name) for the minibatch
        ``idx``, which must be sentiment-pure (the batch sentiment is
        ``senti[idx[0]]``)."""
        conf = self.conf
        _check_on(self.device, idx=idx, **{k: params[k] for k in params},
                  **{f"data[{k!r}]": v for k, v in data.items()})
        senti0 = data["senti"][idx][0]
        b, t = idx.shape[0], data["X"].shape[1]
        x_drop, y_drop = self._dropouts(b, t, generator, x_drop, y_drop)
        idx, x_drop, y_drop = self._local(idx, x_drop, y_drop)
        x, y = data["X"][idx], data["Y"][idx]
        mask, v, sw = data["Xlen"][idx], data["V"][idx], data["SW"][idx]
        tmask = sw_model.switch_param_mask(params)
        trainable = self.solver.trainable_keys(params)
        with torch.enable_grad():
            p = {k: q.detach().requires_grad_(k in trainable)
                 for k, q in params.items()}
            if self.use_chunked:
                (hh_o, hh_n, att), la, l1a = sw_model.forward(
                    p, conf, x, v, senti0, x_drop, y_drop,
                    return_hiddens=True)
                loss = sw_model.loss_fn_from_hiddens(
                    p, conf, hh_o, hh_n, att, senti0, y, mask, sw, la, l1a)
            else:
                s_, la, l1a = sw_model.forward(p, conf, x, v, senti0, x_drop,
                                               y_drop)
                loss = sw_model.loss_fn(conf, s_, y, mask, sw, la, l1a)
            if self.ndata == 1:
                cost = sw_model.cost_fn(p, conf, loss, tmask)
            else:
                cost = loss + sw_model.cost_fn(
                    p, conf, torch.zeros_like(loss), tmask) / self.ndata
            got = torch.autograd.grad(cost, [p[k] for k in trainable],
                                      allow_unused=True)
        return self._shared(loss, dict(zip(trainable, got)))


def make_base_step(conf: dict, solver, mesh=None, device="cuda") -> BaseStep:
    """The base-model step over device-resident data (``data`` from
    ``io.device_dataset``).  ``conf["CHUNKED_CE"]`` and
    ``conf["FUSED_SCAN"]`` (None = on for CUDA) select the chunked loss and
    K8; on a ``mesh`` the step is data parallel (the module docstring):
    every rank is given the same global index row ``idx``."""
    return BaseStep(conf, solver, device, mesh)


def make_switched_step(conf: dict, solver, mesh=None,
                       device="cuda") -> SwitchedStep:
    """The switched-model step over device-resident data.
    ``conf["CHUNKED_CE"]`` (None = on for CUDA) computes the mixture CE
    from the two heads' hidden states in time chunks and
    ``conf["FUSED_SCAN"]`` sends both recurrences to K8; ``mesh`` as in
    :func:`make_base_step`."""
    return SwitchedStep(conf, solver, device, mesh)


def _make_epoch(step):
    """A whole epoch of ``step`` over a device-resident split:
    ``epoch(params, opt_state, data, idx_rows, generator) -> (params,
    opt_state, generator, losses)`` runs the step once an index row of
    ``idx_rows`` ((n, batch) on the device), in order, drawing from
    ``generator`` as the step loop does; each step's loss goes into an (n,)
    float64 tensor on the device, read once at the end (``losses`` on the
    CPU).  The port of the JAX package's one-dispatch ``lax.scan``: the
    same steps, no read between them."""

    def epoch(params, opt_state, data, idx_rows, generator=None):
        losses = torch.empty(len(idx_rows), dtype=torch.float64,
                             device=step.device)
        for r, idx in enumerate(idx_rows):
            params, opt_state, loss = step(params, opt_state, data, idx,
                                           generator)
            losses[r] = loss
        return params, opt_state, generator, losses.cpu()

    return epoch


def make_base_epoch(conf: dict, solver, mesh=None, device="cuda"):
    """Whole-epoch base-model training (see :func:`_make_epoch`) over
    :func:`make_base_step`."""
    return _make_epoch(make_base_step(conf, solver, mesh, device))


def make_switched_epoch(conf: dict, solver, mesh=None, device="cuda"):
    """Whole-epoch switch training (see :func:`_make_epoch`) over
    :func:`make_switched_step`; each index row must be sentiment-pure
    (:func:`_epoch_indices_by_sentiment`), because the step reads the
    batch-level ``senti[idx][0]``."""
    return _make_epoch(make_switched_step(conf, solver, mesh, device))


def _run_epoch(epoch_fn, params, opt_state, data, idx_rows, gen,
               device_epoch: bool):
    """One epoch through ``epoch_fn``: whole (``device_epoch``: the losses
    read once) or a row at a time (each loss read after its step)."""
    losses = []
    for rows in ([idx_rows] if device_epoch else idx_rows.split(1)):
        params, opt_state, gen, ls = epoch_fn(params, opt_state, data, rows,
                                              gen)
        losses += ls.tolist()
    return params, opt_state, losses


def _mesh_batch(conf: dict, dataset: sio.SentiDataset, mesh,
                params: dict) -> int:
    """The minibatch (checked to divide the data axis on a mesh, whose
    ranks then start from rank 0's ``params``, broadcast in place)."""
    batch = min(conf["batch_size_val"], dataset.X.shape[0])
    if mesh is not None:
        row_slice(batch, mesh)
        broadcast_params(params)
    return batch


def _say(mesh, text: str) -> None:
    if mesh is None or mesh.is_writer:
        print(text)


def train_base(dataset: sio.SentiDataset, vocab_size: int,
               conf: Optional[dict] = None, num_epochs: int = 10,
               unigram: Optional[np.ndarray] = None,
               callbacks: Optional[list] = None, seed: int = 0, mesh=None,
               device_epoch: bool = False, device="cuda",
               init_params_override: Optional[dict] = None):
    """Base-model training loop (``train_complete``, ``mrnn.py:727-770``).
    ``device_epoch`` runs the same steps and reads the losses back once per
    epoch instead of once per step (the same parameters and losses).
    ``init_params_override``: a pre-built parameter set, on ``device``,
    trained in place instead of a fresh draw (the CLI's init seam).
    ``mesh``: data parallel (the module docstring); the parameters start
    as rank 0's, and the minibatch must divide by the data axis."""
    conf = conf or senticap_conf()
    dev = resolve_indexed_device(device if mesh is None else mesh.device)
    if init_params_override is not None:
        params = init_params_override
    else:
        params = base_model.init_params(torch.Generator().manual_seed(seed),
                                        vocab_size, conf, unigram,
                                        device=dev)
    solver = make_solver(conf)
    opt_state = solver.init(params)
    epoch_fn = make_base_epoch(conf, solver, mesh, device=dev)
    data = sio.device_dataset(dataset, dev)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = _mesh_batch(conf, dataset, mesh, params)
    for epoch in range(num_epochs):
        t0 = time.time()
        idx_rows = torch.as_tensor(
            _epoch_indices(dataset.X.shape[0], batch, rng), device=dev)
        params, opt_state, losses = _run_epoch(
            epoch_fn, params, opt_state, data, idx_rows, gen, device_epoch)
        _say(mesh, f"[senticap base] epoch {epoch}: loss "
                   f"{np.mean(losses):.3f} ({time.time() - t0:.1f}s)")
        for cb in callbacks or []:
            cb(epoch, params)
    return params, opt_state


def train_switched(dataset: sio.SentiDataset, base_params: dict,
                   vocab_size: int, conf: Optional[dict] = None,
                   num_epochs: int = 10, callbacks: Optional[list] = None,
                   seed: int = 0, init_params_override: Optional[dict] = None,
                   mesh=None, device_epoch: bool = False, device="cuda"):
    """Switch training (``run_train_gap_filler``, ``train_joint.py:322-451``):
    seed both paths from ``base_params``, train only the switch set over
    sentiment-pure minibatches.

    ``init_params_override``: a pre-built switched parameter set (e.g.
    after :func:`~icee_tpu_torch.senticap.switched.grow_vocab`) used, on
    its device, instead of re-initializing from ``base_params``; it is
    updated in place.  ``device_epoch`` runs the same steps and reads the
    losses back once per epoch instead of once per step (the same
    parameters and losses).  ``mesh`` as in :func:`train_base`."""
    conf = conf or senticap_conf()
    dev = resolve_indexed_device(device if mesh is None else mesh.device)
    if init_params_override is not None:
        params = init_params_override
    else:
        params = sw_model.init_params(torch.Generator().manual_seed(seed),
                                      vocab_size, conf, base=base_params,
                                      device=dev)
    solver = make_solver(conf, sw_model.switch_param_mask(params))
    opt_state = solver.init(params)
    epoch_fn = make_switched_epoch(conf, solver, mesh, device=dev)
    data = sio.device_dataset(dataset, dev)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = _mesh_batch(conf, dataset, mesh, params)
    for epoch in range(num_epochs):
        t0 = time.time()
        batches = _epoch_indices_by_sentiment(dataset.senti, batch, rng)
        idx_rows = torch.as_tensor(
            np.stack(batches) if batches else np.zeros((0, batch), np.int64),
            device=dev)
        params, opt_state, losses = _run_epoch(
            epoch_fn, params, opt_state, data, idx_rows, gen, device_epoch)
        _say(mesh, f"[senticap switch] epoch {epoch}: loss "
                   f"{np.mean(losses) if losses else float('nan'):.3f} "
                   f"({time.time() - t0:.1f}s)")
        for cb in callbacks or []:
            cb(epoch, params)
    return params, opt_state


@torch.no_grad()
def validation_perplexity(params, conf, dataset: sio.SentiDataset,
                          switched: bool = False, base_only: bool = False,
                          device="cuda") -> float:
    """Masked corpus perplexity (``get_val_perplexity``; ``base_only``
    evaluates the background model inside a switched param set,
    ``mrnn_switched.py:1301``).  With ``conf["CHUNKED_CE"]`` (None = on for
    CUDA) the (B, T, V) distributions never exist: each block goes through
    the chunked neglog2 sums (the mixture's for the switched model, at the
    split's sentiment ``senti[0]``).

    The split is evaluated in blocks of ``conf["batch_size_val"]`` rows
    (the training batch), their neglog2 sums added: the JAX package's one
    pass over the whole split would hand K8 a batch of every row, whose
    activations (and, on the materialized path, (N, T, V) floats) a block
    keeps off the card.  The sum's order is the only difference."""
    dev = resolve_indexed_device(device)
    use_chunked = (base_model.chunked_ce_requested(conf, dev)
                   and conf.get("SOFTMAX_OUT", True))
    data = sio.device_dataset(dataset, dev)
    mixture = switched and not base_only
    p = params if mixture else {k: params[k] for k in BASE_KEYS}
    _check_on(dev, **p)
    senti0 = data["senti"][0]
    n = int(data["X"].shape[0])
    block = max(1, int(conf["batch_size_val"]))
    hsum = torch.zeros((), dtype=torch.float32, device=dev)
    for r0 in range(0, n, block):
        x, y, mask, v = (data[k][r0:r0 + block]
                         for k in ("X", "Y", "Xlen", "V"))
        hsum = hsum + _neglog2_sum(p, conf, x, y, mask, v, senti0, mixture,
                                   use_chunked)
    return float(2.0 ** (hsum / torch.sum(data["Xlen"])))


def _neglog2_sum(p, conf, x, y, mask, v, senti0, mixture: bool,
                 use_chunked: bool) -> torch.Tensor:
    """``sum(mask * -log2(p(y) + 1e-20))`` of one block of rows."""
    from icee_tpu_torch.ops.chunked_loss import (
        masked_neglog2_sum_from_hiddens, mixture_neglog2_sum_from_hiddens)

    if mixture and use_chunked:
        (hh_o, hh_n, att), _, _ = sw_model.forward(p, conf, x, v, senti0,
                                                   return_hiddens=True)
        co, cn = sw_model.mixture_coefficients(conf, att, senti0)
        return mixture_neglog2_sum_from_hiddens(
            hh_o, hh_n, co, cn, p["w"], p["b"], p["w_sw"], p["b_sw"], y,
            mask)
    if use_chunked:
        hh = base_model.forward(p, conf, x, v, return_hiddens=True)
        return masked_neglog2_sum_from_hiddens(hh, p["w"], p["b"], y, mask)
    s = (sw_model.forward(p, conf, x, v, senti0)[0] if mixture
         else base_model.forward(p, conf, x, v))
    prob = torch.gather(s, -1, y.long()[..., None])[..., 0]
    return torch.sum(-torch.log2(prob + 1e-20) * mask)


def make_beam_step(params, conf, switched: bool = False):
    """``(senti_val) -> step_fn`` for :func:`make_device_beam`'s contract:
    the switched model's :func:`~icee_tpu_torch.senticap.switched.beam_step`
    at sentiment ``senti_val`` (it also returns the gate), or the base
    model's :func:`~icee_tpu_torch.senticap.model.beam_step` (where
    ``senti_val`` selects nothing)."""
    if switched:
        return lambda senti_val: sw_model.beam_step(params, conf, senti_val)
    return lambda senti_val: base_model.beam_step(params, conf)


def _mega_eligible(conf, switched: bool) -> bool:
    """The whole-search kernels cover the test regime: softmax head, no
    batch norm, DA_SUM mixture (the switched kernel's mode)."""
    return (conf.get("SOFTMAX_OUT", True)
            and not conf.get("BATCH_NORM", False)
            and (not switched or conf.get("DOMAIN_ADAPT") == DA_SUM))


@torch.no_grad()
def decode_split(params, conf, dataset: sio.SentiDataset,
                 i2w: Dict[int, str], switched: bool = True,
                 beam_size: int = 20, device: bool = True,
                 torch_device="cuda"):
    """Test path (``run_load_gap_filler``, ``train_joint.py:91-320``).
    Switched model: per image the styled (senti = +1) sentence with its
    switch-gate trace and the descriptive (senti = -1) sentence, ``[{"image",
    "positive", "descriptive", "attention"}]``; base model
    (``switched=False``): one caption per image, ``[{"image", "caption"}]``.

    ``device=True`` runs the whole split's searches at once.  In the
    kernels' regime (``_mega_eligible``) that is K10 for the styled decode
    and K9 on the background weight view for the descriptive one (with
    senti <= -0.5 the switched model outputs exactly the background
    distribution), or K9 for the base model; on CUDA tensors a kernel
    launches or the call raises, with no fallback.  Outside the regime
    (BATCH_NORM, SOFTMAX_OUT=False, DOMAIN_ADAPT other than DA_SUM) the
    model's own device beam of ``senticap/beam.py`` runs, for which there is
    no kernel.  ``device=False`` keeps the host-driven oracle loop.
    ``torch_device`` is where the search runs (CUDA unless the caller asks
    for the CPU); ``params`` must be there."""
    from icee_tpu_torch.senticap.beam import beam_decode, make_device_beam

    dev = resolve_indexed_device(torch_device)
    base = {k: params[k] for k in BASE_KEYS}
    _check_on(dev, **(params if switched else base))
    width = (2 if switched else 1) * conf["lstm_hidden_size"]
    max_len = conf["MAX_SENTENCE_LEN"]
    make = make_beam_step(params, conf, switched)
    v_all = torch.as_tensor(np.ascontiguousarray(dataset.V), device=dev)
    n = int(v_all.shape[0])
    kw = dict(beam_size=beam_size, max_len=max_len)
    if device:
        if _mega_eligible(conf, switched):
            from icee_tpu_torch.ops.senticap_decode import (
                mega_senticap_beam_decode)

            _, d_seq, d_len = mega_senticap_beam_decode(base, v_all, n,
                                                        conf=conf, **kw)
            if switched:
                from icee_tpu_torch.ops.senticap_switched_decode import (
                    mega_senticap_switched_decode)

                _, p_seq, p_len, p_att = mega_senticap_switched_decode(
                    params, v_all, n, conf=conf, **kw)
        else:
            _, d_seq, d_len = make_device_beam(make(-1.0), width, **kw)(
                v_all)
            if switched:
                _, p_seq, p_len, p_att = make_device_beam(
                    make(1.0), width, with_attention=True, **kw)(v_all)
        d_seq, d_len = d_seq.cpu().numpy(), d_len.cpu().numpy()
        if switched:
            p_seq, p_len, p_att = (a.cpu().numpy()
                                   for a in (p_seq, p_len, p_att))

    def host_step(senti_val, v_row):
        step = make(senti_val)

        def one(words, use_v, h, c):
            words = torch.as_tensor(np.asarray(words), device=dev)[None]
            zero = torch.zeros((1, words.shape[1], width), device=dev)
            h_in = zero if h is None else torch.as_tensor(h, device=dev)[None]
            c_in = zero if c is None else torch.as_tensor(c, device=dev)[None]
            return tuple(a[0] for a in step(words, use_v, h_in, c_in, v_row))

        return one

    out = []
    for i in range(n):
        v_row = v_all[i:i + 1]
        if device:
            des_ids = [int(w) for w in d_seq[i, :int(d_len[i])]]
        else:
            _, des_ids = beam_decode(host_step(-1.0, v_row), dataset.V[i],
                                     beam_size, max_len)
        if not switched:
            out.append({"image": dataset.ids[i],
                        "caption": [i2w[w] for w in des_ids[:-1]]})
            continue
        if device:
            length = int(p_len[i])
            pos_ids = [int(w) for w in p_seq[i, :length]]
            att = [float(a) for a in p_att[i, :length]]
        else:
            _, pos_ids, att = beam_decode(host_step(1.0, v_row),
                                          dataset.V[i], beam_size, max_len,
                                          with_attention=True)
        out.append({"image": dataset.ids[i],
                    "positive": [i2w[w] for w in pos_ids[:-1]],
                    "descriptive": [i2w[w] for w in des_ids[:-1]],
                    "attention": att})
    return out
