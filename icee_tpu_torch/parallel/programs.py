"""Rank programs: what each rank of a world spawned by
:func:`icee_tpu_torch.parallel.launch.spawn` runs for the CPU tests of the
data- and tensor-parallel paths (``tests/test_torch_parallel*.py``,
``tests/test_torch_multihost.py``).  Each is ``program(mesh, payload) ->
result``: the payload holds numpy inputs and configs, the result numpy
trees (the split leaves gathered whole), so the test process compares them
with the JAX package's and the single-process port's.  They live in the
package because a spawned process imports its target by module path.
"""

from __future__ import annotations

import numpy as np
import torch

from icee_tpu_torch.bridge import to_numpy, to_torch
from icee_tpu_torch.parallel import train as ptrain
from icee_tpu_torch.parallel.collectives import vocab_shard
from icee_tpu_torch.parallel.mesh import decoder_param_shardings, make_mesh


def _np(tree):
    """A tensor tree as numpy (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return None if tree is None else to_numpy(tree)


def _leaf(x, dim, mesh):
    return None if x is None else ptrain.gather_leaf(x, dim, mesh)


def several(mesh, p: dict) -> dict:
    """Run each program named in ``p`` (``name`` or ``name:tag``) on its
    payload, in order, in one world -> {key: result} (a world's start
    costs seconds)."""
    return {key: globals()[key.split(":")[0]](mesh, payload)
            for key, payload in p.items()}


def round_trip(mesh, p: dict) -> dict:
    """A whole decoder cut into this rank's slices and gathered again, and
    the slices' shapes."""
    dec = ptrain.shard_decoder(p["dec"], mesh)
    back = ptrain.gather_decoder(dec, mesh,
                                 decoder_param_shardings(p["dec"], mesh))
    return {"whole": _np(back),
            "shapes": {k: tuple(v.shape) for k, v in dec.items()
                       if torch.is_tensor(v)}}


# --- the vocab-parallel losses --------------------------------------------

def vocab_losses(mesh, p: dict) -> dict:
    """The masked-mean CE, the masked-SUM CE with its clamp and the
    mixture CE on each mesh shape of ``p["shapes"]``, the heads split over
    the model axis -> {shape: {case: (loss, grads gathered whole)}}."""
    from icee_tpu_torch.ops import chunked_loss as cl

    out = {}
    for shape in p["shapes"]:
        m = mesh if tuple(shape) == mesh.shape else make_mesh(
            shape, device=mesh.device)
        v = p["w"].shape[1]
        vocab = vocab_shard(m, v)

        def cut(x, dim):
            return ptrain.shard_leaf(torch.from_numpy(x), dim, m
                                     ).requires_grad_(True)

        res = {}
        h = torch.from_numpy(p["hiddens"]).requires_grad_(True)
        w, b = cut(p["w"], 1), cut(p["b"], 0)
        tg = torch.from_numpy(p["targets"])
        loss = cl.masked_ce_from_hiddens(
            h, w, b, tg, torch.from_numpy(p["lengths"]),
            torch.from_numpy(p["sample_mask"]), t_chunk=p["t_chunk"],
            vocab=vocab)
        gh, gw, gb = torch.autograd.grad(loss, (h, w, b))
        res["mean"] = (float(loss.detach()),
                       [gh.numpy(), _leaf(gw, 1, m).numpy(),
                        _leaf(gb, 0, m).numpy()])
        loss = cl.masked_sum_ce_from_hiddens(
            h, w, b, tg, torch.from_numpy(p["mask"]), clamp=p["clamp"],
            t_chunk=p["t_chunk"], vocab=vocab)
        gh, gw, gb = torch.autograd.grad(loss, (h, w, b))
        res["sum_clamp"] = (float(loss.detach()),
                            [gh.numpy(), _leaf(gw, 1, m).numpy(),
                             _leaf(gb, 0, m).numpy()])
        mix = [torch.from_numpy(p[k]).requires_grad_(True)
               for k in ("hh_o", "hh_n", "co", "cn")]
        heads = [cut(p[k], d) for k, d in (("w_o", 1), ("b_o", 0),
                                           ("w_n", 1), ("b_n", 0))]
        loss = cl.mixture_ce_from_hiddens(*mix, *heads, tg,
                                          torch.from_numpy(p["weights"]),
                                          vocab=vocab)
        got = torch.autograd.grad(loss, mix + heads)
        whole = [g.numpy() for g in got[:4]] + [
            _leaf(g, d, m).numpy() for g, d in zip(got[4:], (1, 0, 1, 0))]
        res["mixture"] = (float(loss.detach()), whole)
        out[tuple(shape)] = res
    return out


# --- one step of each family -------------------------------------------------

def _steps(p: dict, mesh):
    from icee_tpu_torch.train import optim
    from icee_tpu_torch.train.steps import (make_attention_steps,
                                            make_caption_steps)

    tcfg = p["tcfg"]
    make = (make_attention_steps if p["family"].endswith("_att")
            else make_caption_steps)
    return make(p["cfg"], tcfg, optim.make_adam(1e-3, tcfg),
                optim.make_adam(1e-3, tcfg),
                factored=p["family"].startswith("factored"), device="cpu",
                mesh=mesh)


def step_grads(mesh, p: dict) -> dict:
    """One factual and one emotion step's (loss, gradients) of
    ``p["family"]`` on the mesh, and for StyleNet the paper regime's
    text-only style step's (with the emotion step's draws), the global
    batch and draws of ``p`` given to every rank -> numpy trees, the
    decoder's split leaves gathered whole, and the head's BatchNorm
    statistics after the factual step."""
    steps = _steps(p, mesh)
    specs = decoder_param_shardings(p["dec"], mesh)
    dec = ptrain.shard_decoder(p["dec"], mesh)
    att = p["family"].endswith("_att")
    head = None if att else to_torch(p["head"])
    batch = [torch.from_numpy(p[k]) for k in
             ("feats", "captions", "lengths", "sample_mask")]

    def whole(g):
        return _np(ptrain.gather_decoder(g, mesh, specs))

    out = {"params": _np(ptrain.gather_decoder(dec, mesh, specs))}
    for track, keep, coins in (("factual", *p["draws"][0]),
                               ("emotion", *p["draws"][1])):
        kw = dict(keep=keep, coins=coins)
        if att:
            fn = steps.factual_grads if track == "factual" else \
                steps.emotion_grads
            args = batch + ([] if track == "factual" else [p["style"]])
            loss, g = fn(dec, *args, **kw)
            out[track] = (float(loss), whole(g))
            continue
        if track == "factual":
            loss, (gd, gh), new_head = steps.factual_grads(dec, head, *batch,
                                                           **kw)
            out[track] = (float(loss), whole(gd), _np(gh))
            out["bn"] = _np(new_head["bn"])
        else:
            loss, gd, _ = steps.emotion_grads(dec, head, *batch, p["style"],
                                              **kw)
            out[track] = (float(loss), whole(gd))
    if p["family"] == "factored":
        from icee_tpu_torch.train import optim
        from icee_tpu_torch.train.steps import TextStyleStep

        step = TextStyleStep(p["cfg"], p["tcfg"],
                             optim.make_adam(1e-3, p["tcfg"]), device="cpu",
                             mesh=mesh)
        keep, coins = p["draws"][1]
        loss, g = step.grads(dec, *batch[1:], p["style"], keep=keep,
                             coins=coins)
        out["text_style"] = (float(loss), whole(g))
    return out


# --- the trainers ------------------------------------------------------------

def _loader(p: dict, name: str, bs: int, train: bool):
    """A host loader over ``p["datasets"][name]`` (caption examples, built
    in the test process: tokenizing here would import nltk in every
    rank), or with ``p["resident"]`` the split pinned on the device."""
    from icee_tpu_torch.data.pipeline import caption_dataset_loader

    if p.get("resident"):
        from icee_tpu_torch.data.device import from_examples

        return from_examples(p["datasets"][name], bs,
                             p["tcfg"].max_caption_len,
                             p["features"].__getitem__, shuffle=train,
                             seed=0, device="cpu")
    return caption_dataset_loader(
        p["datasets"][name], batch_size=bs,
        max_len=p["tcfg"].max_caption_len,
        image_provider=p["features"].__getitem__, shuffle=train, seed=0,
        prefetch=0)


def trainer(mesh, p: dict) -> dict:
    """``p["kind"]``'s trainer (multitask, transfer, paper or seq2seq) for
    ``p["epochs"]`` epochs on the mesh over ``p["datasets"]`` ("train",
    "emotion" and, for the paper regime, the styled corpora by emotion;
    pinned on the device with ``p["resident"]``) -> the final whole
    parameters, this rank's slices (but for seq2seq) and every training
    step's loss in order."""
    from icee_tpu_torch.data.pipeline import styled_caption_loader
    from icee_tpu_torch.train import loops

    tc = p["tcfg"]
    kw = dict(log_path=p.get("log_path"), mesh=mesh, device="cpu")
    fac = _loader(p, "train", tc.caption_batch_size, True)
    emo = _loader(p, "emotion", tc.language_batch_size, True)
    if p["kind"] == "seq2seq":
        tr = loops.Seq2SeqTrainer(p["cfg"], tc, p["vocab"], p["dec"],
                                  p["head"], **kw)
        losses = _record_losses(tr)
        tr.train(fac, {"happy": emo}, p["epochs"],
                 val_loader=_loader(p, "train", tc.caption_batch_size,
                                    False),
                 val_emotion_loaders={"happy": _loader(
                     p, "emotion", tc.language_batch_size, False)})
        return {"dec": _np(tr.params), "head": _np(tr.head),
                "losses": np.array(losses)}
    cls = {"multitask": loops.MultitaskTrainer,
           "transfer": loops.TransferTrainer,
           "paper": loops.PaperRegimeTrainer}[p["kind"]]
    tr = cls(p["cfg"], tc, p["vocab"], p["dec"], p["head"],
             family=p["family"], model_dir=p["model_dir"], data_name="demo",
             metrics_path=p.get("metrics_path"), **kw)
    val = _loader(p, "train", tc.caption_batch_size, False)
    val_emo = _loader(p, "emotion", tc.language_batch_size, False)
    losses = _record_losses(tr)
    if p["kind"] == "multitask":
        tr.train(fac, val, emo, val_emo, p["epochs"])
    elif p["kind"] == "transfer":
        tr.train_transfer(emo, val_emo, p["epochs"])
    else:
        styled = {e: styled_caption_loader(
            ds, batch_size=tc.language_batch_size,
            max_len=tc.max_caption_len, seed=0)
            for e, ds in p["datasets"]["styled"].items()}
        tr.train(fac, styled, p["epochs"])
    return {"dec": _np(tr._whole_dec()), "head": _np(tr.head),
            "slices": _np(tr.dec), "losses": np.array(losses)}


def _record_losses(tr) -> list:
    """Wrap ``tr``'s training steps (``_apply_step``, or the seq2seq
    trainer's ``_factual`` and ``_emotion``, and, in the paper regime, each
    style's text-only step) so that every step's loss, summed over the data
    group, is appended to the returned list in order."""
    losses = []

    def recording(step, index):
        def run(*args, **kwargs):
            out = step(*args, **kwargs)
            losses.append(float(out if index is None else out[index]))
            return out
        return run

    for name in ("_apply_step", "_factual", "_emotion"):
        if hasattr(tr, name):
            setattr(tr, name, recording(getattr(tr, name), None))
    for emo, step in getattr(tr, "style_steps", {}).items():
        tr.style_steps[emo] = recording(step, 2)
    return losses


# --- the sharded decodes -----------------------------------------------------

def decodes(mesh, p: dict) -> dict:
    """The sharded K2 (both cells) and K7 (both kinds) searches over the
    data axis -> {name: (tokens, lengths, scores)}."""
    from icee_tpu_torch.decode import fast

    out = {}
    with torch.no_grad():
        for name, (cell, dec, feats) in p["k2"].items():
            res = fast.sharded_factored_decode(
                to_torch(dec), None if feats is None else
                torch.from_numpy(feats), p["style"], mesh, p["batch"],
                p["k"], p["max_len"], 1, 2, cell=cell)
            out[name] = tuple(x.numpy() for x in res)
        for name, (kind, dec, spatial) in p["k7"].items():
            res = fast.sharded_attention_decode(
                to_torch(dec), torch.from_numpy(spatial), p["style"], mesh,
                p["batch"], p["k"], p["max_len"], 1, 2, kind=kind)
            out[name] = tuple(x.numpy() for x in res)
    return out


# --- SentiCap ----------------------------------------------------------------

def senticap(mesh, p: dict) -> dict:
    """``train_base`` then ``train_switched`` from it, on the mesh ->
    both final parameter sets."""
    from icee_tpu_torch.senticap.train import train_base, train_switched

    base, _ = train_base(p["ds"], p["V"], p["conf"], num_epochs=p["epochs"],
                         seed=1, mesh=mesh, device="cpu")
    sw, _ = train_switched(p["sw_ds"], base, p["V"], p["conf"],
                           num_epochs=p["epochs"], seed=1, mesh=mesh,
                           device="cpu")
    return {"base": _np(base), "switched": _np(sw)}


# --- the multi-host start-up -------------------------------------------------

def multihost_cli(rank: int, argv: list) -> None:
    """One process of a training run started with JAX's multi-host flags:
    ``python -m icee_tpu_torch.cli.train ... --data_parallel
    --coordinator_address host:port --num_processes N`` with this rank's
    ``--process_id`` (the CLI brings the world up over ``tcp://`` and takes
    it down at the end)."""
    from icee_tpu_torch.cli import train

    torch.set_num_threads(1)
    train.main(train.parser().parse_args(argv + ["--process_id",
                                                 str(rank)]))
