"""SentiCap training and test entry points, the base model's half (port of
``icee_tpu/senticap/train.py``; reference ``train_mscoco.py``).

The reference compiles a Theano ``train(indx)`` whose minibatch gather
happens on the device from shared arrays (``mrnn.py:570-677``); here the
split lives on the device (``io.device_dataset``) and one step gathers rows
by an index vector, runs the forward, the masked-SUM loss and the L2 term,
the gradient, then the reference's RMSProp/Adadelta pipeline.

``train_base`` is the COCO base-model regime (``train_mscoco.py:1-59``);
``validation_perplexity`` and ``decode_split`` evaluate and decode it.  On
CUDA the teacher-forced scan runs K8 (``ops/senticap_scan.py``), the loss
the chunked CE kernels, and ``decode_split`` the whole beam search K9
(``ops/senticap_decode.py``).  The switched model (``train_switched``, the
switched branches below) comes with slice 7c of the port, and the data
parallel ``mesh`` with slice 8.

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
from icee_tpu_torch.senticap import io as sio
from icee_tpu_torch.senticap import model as base_model
from icee_tpu_torch.senticap.config import DA_SUM, senticap_conf
from icee_tpu_torch.senticap.solver import make_solver

BASE_KEYS = ("wemb", "w_lstm", "w", "b", "wvm", "bmv")


def _switched_later(what: str):
    return NotImplementedError(
        f"{what}: the switched SentiCap model comes with slice 7c of the "
        "port")


def _check_on(device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")


def _epoch_indices(n: int, batch: int, rng: np.random.Generator):
    idx = rng.permutation(n)
    n_batches = n // batch
    return idx[: n_batches * batch].reshape(n_batches, batch)


def _dropout(generator, shape, frac: float, device) -> torch.Tensor:
    keep = torch.rand(shape, generator=generator, device=device) < 1.0 - frac
    return keep.to(torch.float32) / (1.0 - frac)


class BaseStep:
    """One base-model step over a device-resident split (see
    :func:`make_base_step`)."""

    def __init__(self, conf: dict, solver, device):
        self.conf, self.solver = conf, solver
        self.device = resolve_indexed_device(device)
        self.use_chunked = (base_model.chunked_ce_requested(conf, self.device)
                            and conf.get("SOFTMAX_OUT", True))

    def _masks(self, b, t, generator, x_drop, y_drop, forced):
        conf, dev = self.conf, self.device
        if x_drop is None:
            x_drop = _dropout(generator, (b, t, conf["emb_size"]),
                              conf["DROP_INPUT_FRACTION"], dev)
        if y_drop is None:
            y_drop = _dropout(generator, (b, t, conf["lstm_hidden_size"]),
                              conf["DROP_OUTPUT_FRACTION"], dev)
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
        x, y = data["X"][idx], data["Y"][idx]
        mask, v = data["Xlen"][idx], data["V"][idx]
        b, t = x.shape
        x_drop, y_drop, forced = self._masks(b, t, generator, x_drop, y_drop,
                                             forced)
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
            cost = loss + conf["L2_REG_CONST"] * l2
            got = torch.autograd.grad(cost, list(p.values()))
        return loss.detach(), dict(zip(p, got))

    def __call__(self, params: dict, opt_state: dict, data: dict,
                 idx: torch.Tensor,
                 generator: Optional[torch.Generator] = None, x_drop=None,
                 y_drop=None, forced=None):
        """-> (params, opt_state, loss), ``params`` updated in place."""
        loss, grads = self.grads(params, data, idx, generator, x_drop,
                                 y_drop, forced)
        opt_state = self.solver.update(grads, opt_state, params)
        return params, opt_state, loss


def make_base_step(conf: dict, solver, mesh=None, device="cuda") -> BaseStep:
    """The base-model step over device-resident data (``data`` from
    ``io.device_dataset``).  ``conf["CHUNKED_CE"]`` and
    ``conf["FUSED_SCAN"]`` (None = on for CUDA) select the chunked loss and
    K8; ``mesh`` (data parallelism) comes with slice 8 of the port."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel SentiCap steps (mesh) come with slice 8 of the "
            "port")
    return BaseStep(conf, solver, device)


def train_base(dataset: sio.SentiDataset, vocab_size: int,
               conf: Optional[dict] = None, num_epochs: int = 10,
               unigram: Optional[np.ndarray] = None,
               callbacks: Optional[list] = None, seed: int = 0, mesh=None,
               device_epoch: bool = False, device="cuda"):
    """Base-model training loop (``train_complete``, ``mrnn.py:727-770``).
    ``device_epoch`` runs the same steps and reads the losses back once per
    epoch instead of once per step (the same parameters and losses)."""
    conf = conf or senticap_conf()
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel SentiCap training (mesh) comes with slice 8 of "
            "the port")
    dev = resolve_indexed_device(device)
    params = base_model.init_params(torch.Generator().manual_seed(seed),
                                    vocab_size, conf, unigram, device=dev)
    solver = make_solver(conf)
    opt_state = solver.init(params)
    step = make_base_step(conf, solver, device=dev)
    data = sio.device_dataset(dataset, dev)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = min(conf["batch_size_val"], dataset.X.shape[0])
    for epoch in range(num_epochs):
        t0 = time.time()
        idx_rows = torch.as_tensor(
            _epoch_indices(dataset.X.shape[0], batch, rng), device=dev)
        losses = []
        for idx in idx_rows:
            params, opt_state, loss = step(params, opt_state, data, idx, gen)
            losses.append(loss if device_epoch else float(loss))
        if device_epoch and losses:
            losses = torch.stack(losses).double().cpu().tolist()
        print(f"[senticap base] epoch {epoch}: loss "
              f"{np.mean(losses):.3f} ({time.time() - t0:.1f}s)")
        for cb in callbacks or []:
            cb(epoch, params)
    return params, opt_state


@torch.no_grad()
def validation_perplexity(params, conf, dataset: sio.SentiDataset,
                          switched: bool = False, device="cuda") -> float:
    """Masked corpus perplexity (``get_val_perplexity``).  With
    ``conf["CHUNKED_CE"]`` (None = on for CUDA) the (B, T, V) distributions
    never exist: the split evaluates in one pass through the chunked
    neglog2 sum.  The switched model comes with slice 7c."""
    if switched:
        raise _switched_later("validation_perplexity(switched=True)")
    dev = resolve_indexed_device(device)
    use_chunked = (base_model.chunked_ce_requested(conf, dev)
                   and conf.get("SOFTMAX_OUT", True))
    data = sio.device_dataset(dataset, dev)
    y, mask = data["Y"], data["Xlen"]
    p = {k: params[k] for k in BASE_KEYS}
    _check_on(dev, **p)
    if use_chunked:
        from icee_tpu_torch.ops.chunked_loss import (
            masked_neglog2_sum_from_hiddens)

        hh = base_model.forward(p, conf, data["X"], data["V"],
                                return_hiddens=True)
        hsum = masked_neglog2_sum_from_hiddens(hh, p["w"], p["b"], y, mask)
        return float(2.0 ** (hsum / torch.sum(mask)))
    s = base_model.forward(p, conf, data["X"], data["V"])
    return float(base_model.perplexity(s, y, mask))


def make_beam_step(params, conf, switched: bool = False):
    """``(senti_val) -> step_fn`` for :func:`make_device_beam`'s contract:
    the base model's :func:`~icee_tpu_torch.senticap.model.beam_step`
    (``senti_val`` selects nothing in the base model)."""
    if switched:
        raise _switched_later("make_beam_step(switched=True)")
    return lambda senti_val: base_model.beam_step(params, conf)


def _mega_eligible(conf, switched: bool) -> bool:
    """The whole-search kernels cover the test regime: softmax head, no
    batch norm, DA_SUM mixture (the switched kernel's mode)."""
    return (conf.get("SOFTMAX_OUT", True)
            and not conf.get("BATCH_NORM", False)
            and (not switched or conf.get("DOMAIN_ADAPT") == DA_SUM))


@torch.no_grad()
def decode_split(params, conf, dataset: sio.SentiDataset,
                 i2w: Dict[int, str], switched: bool = False,
                 beam_size: int = 20, device: bool = True,
                 torch_device="cuda"):
    """Test path (``run_load_gap_filler``, ``train_joint.py:91-320``), base
    model: one beam-``beam_size`` caption per image, ``[{"image",
    "caption"}]``.

    ``device=True`` runs the whole split's searches at once: through K9 in
    the kernel's regime (``_mega_eligible``), which on CUDA tensors launches
    or raises, with no fallback; outside it (BATCH_NORM, SOFTMAX_OUT=False),
    the model's own device beam of ``senticap/beam.py``, for which there is
    no kernel.  ``device=False`` keeps the host-driven oracle loop.
    ``torch_device`` is where the search runs (CUDA unless the caller asks
    for the CPU); ``params`` must be there.  ``switched=True`` comes with
    slice 7c of the port."""
    from icee_tpu_torch.senticap.beam import beam_decode, make_device_beam

    if switched:
        raise _switched_later("decode_split(switched=True)")
    dev = resolve_indexed_device(torch_device)
    base = {k: params[k] for k in BASE_KEYS}
    _check_on(dev, **base)
    hs = conf["lstm_hidden_size"]
    max_len = conf["MAX_SENTENCE_LEN"]
    make = make_beam_step(params, conf, switched)
    v_all = torch.as_tensor(np.ascontiguousarray(dataset.V), device=dev)
    n = int(v_all.shape[0])
    d_seq = d_len = None
    if device:
        if _mega_eligible(conf, switched):
            from icee_tpu_torch.ops.senticap_decode import (
                mega_senticap_beam_decode)

            _, d_seq, d_len = mega_senticap_beam_decode(
                base, v_all, n, beam_size=beam_size, max_len=max_len,
                conf=conf)
        else:
            run = make_device_beam(make(-1.0), hs, beam_size, max_len)
            _, d_seq, d_len = run(v_all)
        d_seq, d_len = d_seq.cpu().numpy(), d_len.cpu().numpy()

    out = []
    for i in range(n):
        if device:
            ids = [int(w) for w in d_seq[i, :int(d_len[i])]]
        else:
            step = make(-1.0)
            v_row = v_all[i:i + 1]

            def one(words, use_v, h, c, step=step, v_row=v_row):
                words = torch.as_tensor(np.asarray(words), device=dev)[None]
                b = words.shape[1]
                zero = torch.zeros((1, b, hs), device=dev)
                h_in = zero if h is None else torch.as_tensor(
                    h, device=dev)[None]
                c_in = zero if c is None else torch.as_tensor(
                    c, device=dev)[None]
                s, h2, c2 = step(words, use_v, h_in, c_in, v_row)
                return s[0], h2[0], c2[0]

            _, ids = beam_decode(one, dataset.V[i], beam_size, max_len)
        out.append({"image": dataset.ids[i],
                    "caption": [i2w[w] for w in ids[:-1]]})
    return out
