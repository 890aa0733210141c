"""``python -m icee_tpu_torch.cli.senticap_train`` — SentiCap drivers (port
of ``icee_tpu/cli/senticap_train.py``; reference ``train_mscoco.py`` /
``train_joint.py``, SURVEY C10).

Subcommands mirror the reference CLI (``train_joint.py:453-491``:
``train|test -s pos|neg``):

- ``base``   — train the background COCO-style caption model
  (``train_mscoco.py``); the model pickle stores the vocabulary
- ``train``  — switch ("gap filler") training from a base checkpoint
  (``run_train_gap_filler``): REUSES the base model's vocabulary, appending
  new sentiment words with nearest-embedding vocab surgery
  (``mrnn_switched.py:480-518``; closeness is cosine over the base model's
  own trained ``wemb``: a new word's vector is the mean embedding of its
  in-vocab context words in the sentiment corpus —
  ``switched.make_embedding_closest_fn``)
- ``test``   — beam-decode the styled and descriptive sentence per image
  with switch-attention traces (``run_load_gap_filler``), using the sizes
  and vocabulary SAVED IN the model pickle

``-s pos|neg`` tags records that carry no explicit ``sentiment`` field
(+1 styled / -1 descriptive).

Data: ``--captions`` JSON (records with image/tokens|caption/sentiment/
switch) + ``--features`` npz or .mat (VGG-4096 per image).

The flags and defaults are the JAX CLI's, plus ``--device`` (default
``cuda``; CUDA's absence raises).  On CUDA ``base`` trains through K8 and
the chunked CE, ``train`` through two K8 scans a step and the mixture CE,
and ``test`` decodes through K10 (styled) and K9 (descriptive, or the base
model with ``--base_only``); ``--chunked_ce`` / ``--fused_scan`` ``auto``
mean on for CUDA.  The model pickle is the JAX package's: either package
loads the other's.  ``--data_parallel`` trains ``base`` and ``train``
over every rank of the world (one process per card, ``python -m
torch.distributed.run``; ``senticap/train.py``'s data-parallel steps): the
minibatch must divide by the ranks, every rank starts from rank 0's
weights and rank 0 alone writes the pickle; ``test`` decodes on one card
(as the JAX CLI's), and a world of one process trains single-device with
a WARNING.  Where K8 runs, its launch plan must take the minibatch (a
rank's share under ``--data_parallel``) at the hidden size: on the card
the scans take any B and H up to 2048 (a wider ``--hidden_size`` is refused
with the plan's own message, for ``base`` before any data loads, for
``train`` once the base model's sizes are read).  Fresh weights come from
:func:`init_base` and
:func:`init_switched`, drawn from ``torch.Generator``s seeded ``--seed``
(the JAX CLI draws from ``jax.random.PRNGKey(seed)``, whose numbers torch
cannot reproduce).
"""

import argparse
import json

import numpy as np


def _tokens(records, sio):
    return [r.get("tokens") or sio.tokenize(r.get("caption", ""))
            for r in records]


def init_base(vocab_size: int, conf: dict, unigram, seed: int, device):
    """The base model's fresh parameters on ``device``."""
    import torch

    from icee_tpu_torch.senticap import model as base_model

    return base_model.init_params(torch.Generator().manual_seed(seed),
                                  vocab_size, conf, unigram, device=device)


def init_switched(vocab_size: int, conf: dict, base: dict, seed: int,
                  device):
    """The switched model's parameters on ``device``, both paths seeded
    from ``base``, the gate and the dead sentiment projections fresh."""
    import torch

    from icee_tpu_torch.senticap import switched as sw_model

    return sw_model.init_params(torch.Generator().manual_seed(seed),
                                vocab_size, conf, base=base, device=device)


def check_scan_plan(hidden_size: int, batch_size: int, fused_scan,
                    device, mesh=None) -> None:
    """Where the training scan runs on the card (K8), its launch plan must
    take the minibatch (a rank's share on a mesh) at this hidden size:
    otherwise raise the plan's own ValueError now, not at the first
    step."""
    if device.type != "cuda" or fused_scan is False:
        return
    from icee_tpu_torch.ops import scan_grid, senticap_scan

    batch = batch_size // (mesh.n_data if mesh is not None else 1)
    scan_grid.plan_on(senticap_scan.WHAT, batch, hidden_size, device)


def main(args) -> None:
    from icee_tpu_torch.cli.common import (data_parallel_mesh, device_of,
                                           end_parallel)
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap import train as T
    from icee_tpu_torch.senticap.config import senticap_conf

    device = device_of(args)
    mesh = None
    if args.command != "test":
        mesh = data_parallel_mesh(args, device, "training")
        if mesh is not None:
            device = mesh.device
            if args.batch_size % mesh.n_data:
                raise SystemExit(f"--batch_size {args.batch_size} must "
                                 "divide by the data-axis size "
                                 f"{mesh.n_data}")
    writer = mesh is None or mesh.is_writer
    chunked_ce = {"auto": None, "on": True, "off": False}[args.chunked_ce]
    fused_scan = {"auto": None, "on": True, "off": False}[args.fused_scan]
    if args.command == "base":
        check_scan_plan(args.hidden_size, args.batch_size, fused_scan,
                        device, mesh)
    records = sio.load_captions_json(args.captions)
    default_senti = 1.0 if args.sentiment == "pos" else -1.0
    for r in records:
        r.setdefault("sentiment", default_senti)
    features = sio.load_features(args.features) if args.features else None

    if args.command == "base":
        conf = senticap_conf(
            emb_size=args.emb_size, lstm_hidden_size=args.hidden_size,
            visual_size=args.visual_size, batch_size_val=args.batch_size,
            MAX_SENTENCE_LEN=args.max_len, learning_rate=args.lr,
            CHUNKED_CE=chunked_ce, FUSED_SCAN=fused_scan)
        w2i, _ = sio.build_vocab(_tokens(records, sio),
                                 min_freq=conf["MIN_WORD_FREQ"])
        ds = sio.make_split(records, features, w2i, max_len=args.max_len,
                            visual_size=args.visual_size)
        print(f"vocab {len(w2i)}, split {ds.X.shape}")
        counts = np.bincount(ds.Y[ds.Xlen > 0].ravel(), minlength=len(w2i))
        unigram = counts / max(counts.sum(), 1)
        params, _ = T.train_base(
            ds, len(w2i), conf, num_epochs=args.num_epochs, seed=args.seed,
            device_epoch=args.device_resident, device=device,
            init_params_override=init_base(len(w2i), conf, unigram,
                                           args.seed, device), mesh=mesh)
        ppl = T.validation_perplexity(params, conf, ds, device=device)
        if writer:
            sio.save_model(args.model_out, params, conf, vocab=w2i)
            print(f"saved base model to {args.model_out}")
            print("val perplexity:", ppl)

    elif args.command == "train":
        from icee_tpu_torch.senticap import switched as sw_model

        base_params, conf, _, base_w2i = sio.load_model(args.base_model,
                                                        device)
        check_scan_plan(conf["lstm_hidden_size"], args.batch_size,
                        fused_scan, device, mesh)
        conf = dict(conf)
        conf["batch_size_val"] = args.batch_size
        conf["learning_rate"] = args.lr
        conf["CHUNKED_CE"] = chunked_ce
        conf["FUSED_SCAN"] = fused_scan
        if base_w2i is None:
            raise SystemExit("base model pickle carries no vocabulary; "
                             "retrain it with this CLI")
        # vocab surgery: keep the base vocabulary, append new frequent words
        new_w2i, _ = sio.build_vocab(_tokens(records, sio),
                                     min_freq=conf["MIN_WORD_FREQ"])
        w2i = dict(base_w2i)
        added = []
        for w in new_w2i:
            if w not in w2i:
                w2i[w] = len(w2i)
                added.append((w, w2i[w]))
        sw_params = init_switched(len(base_w2i), conf, base_params,
                                  args.seed, device)
        if added:
            # ClosestWordFinder analogue (mrnn_switched.py:31-73) without
            # spacy: each new sentiment word adopts the base word whose
            # trained embedding is cosine-nearest to the mean embedding of
            # the new word's in-vocab context words in this corpus
            closest = sw_model.make_embedding_closest_fn(
                base_params["wemb"], base_w2i, _tokens(records, sio))
            i2w_base = {v: k for k, v in base_w2i.items()}
            for w, _ in added:
                print(f"  {w} -> {i2w_base[closest(w)]}")
            sw_params = sw_model.grow_vocab(sw_params, added,
                                            closest_fn=closest)
            print(f"vocab surgery: +{len(added)} sentiment words")
        ds = sio.make_split(records, features, w2i,
                            max_len=conf["MAX_SENTENCE_LEN"],
                            visual_size=conf["visual_size"])
        print(f"vocab {len(w2i)}, split {ds.X.shape}")
        params, _ = T.train_switched(
            ds, base_params, len(w2i), conf, num_epochs=args.num_epochs,
            seed=args.seed, init_params_override=sw_params,
            device_epoch=args.device_resident, device=device, mesh=mesh)
        if writer:
            sio.save_model(args.model_out, params, conf, vocab=w2i)
            print(f"saved switched model to {args.model_out}")

    elif args.command == "test":
        params, conf, _, w2i = sio.load_model(args.model_in, device)
        conf = dict(conf)
        if w2i is None:
            raise SystemExit("model pickle carries no vocabulary")
        i2w = {i: w for w, i in w2i.items()}
        # decode each unique image ONCE (the reference dedups with
        # `if img_id in seen_ids: continue`, train_joint.py:162) — caption
        # records only supply references
        seen = set()
        unique_records = []
        for r in records:
            if r["image"] not in seen:
                seen.add(r["image"])
                unique_records.append(r)
        ds = sio.make_split(unique_records, features, w2i,
                            max_len=conf["MAX_SENTENCE_LEN"],
                            visual_size=conf["visual_size"])
        out = T.decode_split(params, conf, ds, i2w,
                             switched=not args.base_only,
                             beam_size=args.beam_size, torch_device=device)
        for rec in out[: args.print_n]:
            if "positive" in rec:
                print(f"[{rec['image']}] pos: {' '.join(rec['positive'])}")
                print(f"[{rec['image']}] des: "
                      f"{' '.join(rec['descriptive'])}")
            else:
                print(f"[{rec['image']}] {' '.join(rec['caption'])}")
        if args.out_dir:
            from icee_tpu_torch.senticap.eval_out import (score_decodes,
                                                          write_eval_outputs)

            refs = {}
            for r in records:
                toks = r.get("tokens") or sio.tokenize(r.get("caption", ""))
                refs.setdefault(r["image"], []).append(toks)
            write_eval_outputs(out, refs, args.out_dir)
            print(json.dumps(score_decodes(out, refs), default=float))
    else:
        raise SystemExit(f"unknown command {args.command}")
    end_parallel(mesh)


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_parallel_flags

    p = argparse.ArgumentParser()
    p.add_argument("command", choices=["base", "train", "test"])
    p.add_argument("-s", "--sentiment", choices=["pos", "neg"],
                   default="pos")
    p.add_argument("--captions", type=str, required=True)
    p.add_argument("--features", type=str, default=None)
    p.add_argument("--base_model", type=str, default=None)
    p.add_argument("--model_in", type=str, default=None)
    p.add_argument("--model_out", type=str, default="senticap_model.pik")
    p.add_argument("--out_dir", type=str, default=None,
                   help="write eval/output_pos|des + metrics JSON here")
    p.add_argument("--emb_size", type=int, default=512)
    p.add_argument("--hidden_size", type=int, default=512,
                   help="the LSTM's width; on the card K8 takes up to 2048 "
                        "(at any --batch_size)")
    p.add_argument("--visual_size", type=int, default=4096)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--max_len", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--beam_size", type=int, default=20)
    p.add_argument("--base_only", action="store_true")
    p.add_argument("--print_n", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device_resident", action="store_true",
                   help="run each epoch over the split on the device with "
                        "the losses read once an epoch (the same steps and "
                        "parameters as the step-by-step path)")
    p.add_argument("--chunked_ce", choices=["auto", "on", "off"],
                   default="auto",
                   help="chunked (mixture) CE / perplexity — the (B,T,V) "
                        "distributions never materialize; auto = on for "
                        "CUDA")
    p.add_argument("--fused_scan", choices=["auto", "on", "off"],
                   default="auto",
                   help="the training scan's CUDA kernel "
                        "(ops/senticap_scan.py, K8); auto = on for CUDA")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda, cuda:1 or cpu (the plain "
                        "PyTorch versions of the kernels)")
    add_parallel_flags(p, "training")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
