"""``python -m icee_tpu_torch.cli.train`` — unified training CLI (port of
``icee_tpu/cli/train.py``), selected by ``--trainer`` (flags otherwise
mirror ``train_multitask.py:560-634``):

- ``multitask``      -> T2 (``stylenet/train_multitask.py``) / NIC copy
- ``multitask_att``  -> T3 (``train_multitask_att.py``)
- ``transfer_fac``   -> T4 stage-1 factual pretraining
- ``transfer``       -> T5 stage-2 style fine-tune (masked optimizer)
- ``paper``          -> T1 StyleNet-paper regime (text-only style corpora)
- ``seq2seq``        -> T6 seq2seq style transfer (``seq2seq/train.py``)

``--family {stylenet,nic}`` picks the factored vs plain decoder.  On a CUDA
device every training step launches the kernels (K3 or K4, K5 for the
attention families, and the chunked CE) and each validation's sample one K2
search; ``--fused_scan off`` / ``--chunked_ce off`` are the explicit
opt-outs, as in the JAX CLI.

``--device_resident`` holds each split on the device
(``data/device.py``): pinned when its unique features fit
``--device_budget_gb`` (stored as ``--feature_dtype``), streamed in chunks
otherwise, the paper regime's style corpora with ``from_styled``; it needs
constant features (``--no_augment`` or ``--feature_cache``).
``--progress_chunk N`` writes a progress record every N batches of a
device epoch, and a run started again in the same ``--model_path``
resumes from it mid-epoch.

``--trainer seq2seq`` trains on the host loader, or with
``--device_resident`` on pinned splits; a split over the budget falls back
to the host loader with a WARNING line, as in the JAX CLI (the seq2seq
trainer has no streamed tier).

``--data_parallel`` trains on every rank of the world, one process per
card (``icee_tpu_torch/parallel``): started by ``python -m
torch.distributed.run --nproc_per_node N -m icee_tpu_torch.cli.train
--data_parallel ...``, or on several hosts with JAX's ``--coordinator_address
--num_processes --process_id``.  ``--tensor_parallel M`` splits the
vocabulary of the embedding and the head over M ranks of a ``(N / M, M)``
mesh where M divides the world (JAX's ``dp_tp_shape``).  Both batch sizes
must divide by the data axis.  Every rank loads the same data; rank 0
alone logs and writes the checkpoints.  ``--dist_backend gloo`` puts
several ranks on one card (NCCL refuses that); the default follows the
device.  A world of one process trains single-device with a WARNING;
``--tensor_parallel`` or the multi-host flags without ``--data_parallel``
are refused.  On the card the training scans take ``--hidden_size`` up to
2048 and any batch size (past about 704 units, or at large batches,
their recurrence streams W_h: ``ops/scan_grid.py``; a batch of 4096 at H
= 512 trains so); a shape the training scan's launch plan cannot take on
this card is refused with the plan's own message before any data loads.
"""

import argparse

DEVICE_BUDGET_GB = 4.0    # --device_budget_gb's default


def check_scan_plan(family: str, cfg, tcfg, device) -> None:
    """Where the training scan runs on the card (K3 for StyleNet, K4 for
    NIC), its launch plan must take every batch size at this hidden size:
    otherwise raise the plan's own ValueError now, not at the first step."""
    if device.type != "cuda" or family.endswith("_att") or \
            family == "seq2seq" or tcfg.fused_scan is False:
        return
    from icee_tpu_torch.ops import lstm_scan, nic_scan, scan_grid

    what = lstm_scan.WHAT if family == "factored" else nic_scan.WHAT
    for b in sorted({tcfg.caption_batch_size, tcfg.language_batch_size}):
        scan_grid.plan_on(what, b, cfg.hidden_size, device)


def init_weights(family: str, cfg, ecfg, seed: int, device):
    """Fresh (decoder, head) from ``torch.Generator``s seeded ``seed`` and
    ``seed + 1`` (the JAX CLI uses ``jax.random.PRNGKey(seed)`` and
    ``(seed + 1)``, whose draws torch cannot reproduce); the attention
    families have no head.  For ``family="seq2seq"`` the first is the
    seq2seq tree (``cfg`` a ``Seq2SeqConfig``)."""
    import torch

    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.models import encoder as enc_mod
    from icee_tpu_torch.models import factored_lstm as fl
    from icee_tpu_torch.models import lstm as nic_mod

    from icee_tpu_torch.models import seq2seq as s2s

    init = {"factored": fl.init_params, "nic": nic_mod.init_params,
            "factored_att": att_mod.init_factored_att_params,
            "nic_att": att_mod.init_rnn_att_params,
            "seq2seq": s2s.init_params}[family]
    dec = init(torch.Generator().manual_seed(seed), cfg, device=device)
    head = None if family.endswith("_att") else enc_mod.init_head_params(
        torch.Generator().manual_seed(seed + 1), ecfg, device=device)
    return dec, head


def resident_split(ds, path: str, bs: int, train: bool, args, tcfg,
                   provider, feature_dtype, device):
    """A caption split held on ``device`` (``data/device.py``): pinned
    when its unique features fit ``--device_budget_gb`` in their storage
    dtype (``pin_plan``), streamed otherwise (with a NOTE line); for the
    seq2seq trainer, which has no streamed tier, None (with a WARNING
    line): the caller takes the host loader."""
    import numpy as np

    from icee_tpu_torch.data import device as device_data

    if not ds:
        raise SystemExit(f"empty caption set: {path}")
    feat_shape = np.asarray(provider(ds[0].image)).shape
    n_unique = len({e.image for e in ds})
    budget = int(args.device_budget_gb * (1 << 30))
    plan = device_data.pin_plan(
        n_unique, feat_shape, budget_bytes=budget,
        bytes_per_feature=2 if feature_dtype is not None else 4)
    kw = dict(batch_size=bs, max_len=tcfg.max_caption_len,
              image_provider=provider, shuffle=train, seed=args.seed,
              feature_dtype=feature_dtype, device=device)
    if plan == "pin":
        return device_data.from_examples(ds, **kw)
    if args.trainer == "seq2seq":
        print(f"WARNING: {path} features exceed the device-resident "
              "budget; falling back to the host loader")
        return None
    print(f"NOTE: {path} features exceed the device-resident budget; "
          "streaming per-chunk feature buffers "
          f"({args.device_budget_gb:g} GiB, double-buffered)")
    return device_data.from_examples_streamed(ds, budget_bytes=budget, **kw)


def main(args) -> None:
    import torch

    from icee_tpu_torch.cli import common
    from icee_tpu_torch.core.config import EncoderConfig, Seq2SeqConfig
    from icee_tpu_torch.data.captions import (load_caption_dataset,
                                              load_styled_caption_dataset)
    from icee_tpu_torch.data.pipeline import (caption_dataset_loader,
                                              styled_caption_loader)
    from icee_tpu_torch.data import device as device_data
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.train.loops import (MultitaskTrainer,
                                            PaperRegimeTrainer,
                                            Seq2SeqTrainer, TransferTrainer)

    common.refuse_parallel_without_dp(args)
    device = common.device_of(args)
    mesh = common.data_parallel_mesh(args, device, "training",
                                     args.tensor_parallel)
    if mesh is not None:
        from icee_tpu_torch.parallel.data import check_batch_sizes

        check_batch_sizes(common.train_config(args), mesh, SystemExit)
        device = mesh.device
    vocab = load_vocab(args.vocab_path)
    attention = args.trainer.endswith("_att") or args.attention
    cfg = common.decoder_config(args, len(vocab), attention=attention)
    tcfg = common.train_config(args)
    ecfg = EncoderConfig(embed_size=args.embed_size)
    family = "factored" if args.family == "stylenet" else "nic"
    if attention:
        family += "_att"
    if args.trainer == "seq2seq":
        family = "seq2seq"
    check_scan_plan(family, cfg, tcfg, device)

    # training uses the reference augmentation regime (random crop/flip per
    # epoch); validation the deterministic eval transform with feature
    # memoization.  --no_augment opts into the cached fast path for training
    # too (constant eval-mode features).
    provider_eval = common.make_feature_provider(args, spatial=attention)
    if args.no_augment or args.feature_cache:
        provider_train = provider_eval
    else:
        provider_train = common.make_feature_provider(
            args, spatial=attention, augment=True, seed=args.seed)

    emo_paths = {"happy": (args.happy_path, args.val_happy_path),
                 "sad": (args.sad_path, args.val_sad_path),
                 "angry": (args.angry_path, args.val_angry_path)}

    if args.device_resident and not (args.no_augment or args.feature_cache):
        raise SystemExit(
            "--device_resident holds one feature per image on the device, "
            "which requires constant features: pass --no_augment or "
            "--feature_cache (per-epoch crop/flip augmentation would be "
            "frozen at its first draw)")
    feature_dtype = {"float32": None,
                     "bfloat16": torch.bfloat16}[args.feature_dtype]

    def loader(path, bs, train=True):
        ds = load_caption_dataset(path, vocab)
        if args.device_resident:
            split = resident_split(ds, path, bs, train, args, tcfg,
                                   provider_eval, feature_dtype, device)
            if split is not None:
                return split
        return caption_dataset_loader(
            ds, batch_size=bs, max_len=tcfg.max_caption_len,
            image_provider=provider_train if train else provider_eval,
            shuffle=train, seed=args.seed)

    if args.trainer == "seq2seq":
        scfg = Seq2SeqConfig(vocab_size=len(vocab),
                             embed_size=args.embed_size,
                             hidden_size=args.hidden_size,
                             num_layers=args.num_layers,
                             dropout=args.dropout,
                             max_seq_length=args.max_seq_length)
        params, head = init_weights(family, scfg, ecfg, args.seed, device)
        trainer = Seq2SeqTrainer(scfg, tcfg, vocab, params, head,
                                 log_path=args.log_path, mesh=mesh,
                                 device=device)
        trainer.train(
            loader(args.caption_path, tcfg.caption_batch_size),
            {emo: loader(p[0], tcfg.language_batch_size)
             for emo, p in emo_paths.items()},
            val_loader=loader(args.val_caption_path,
                              tcfg.caption_batch_size, train=False),
            val_emotion_loaders={
                emo: loader(p[1], tcfg.language_batch_size, train=False)
                for emo, p in emo_paths.items()})
        common.end_parallel(mesh)
        return
    dec, head = init_weights(family, cfg, ecfg, args.seed, device)
    common_kw = dict(
        cfg=cfg, tcfg=tcfg, vocab=vocab, dec_params=dec, head_params=head,
        family=family, log_path=args.log_path, model_dir=args.model_path,
        data_name=args.data_name, metrics_path=args.metrics_path,
        mesh=mesh, device=device)

    if args.trainer in ("multitask", "multitask_att"):
        trainer = MultitaskTrainer(**common_kw)
        if args.checkpoint_path:
            # full resume: params + both optimizers + plateau counters
            trainer.restore(args.checkpoint_path)
            print(f"start_epoch {trainer.start_epoch}")
        emo_train, emo_val = emo_paths[args.mode]
        trainer.train(
            loader(args.caption_path, tcfg.caption_batch_size),
            loader(args.val_caption_path, tcfg.caption_batch_size,
                   train=False),
            loader(emo_train, tcfg.language_batch_size),
            loader(emo_val, tcfg.language_batch_size, train=False))
    elif args.trainer == "transfer_fac":
        trainer = MultitaskTrainer(**common_kw)
        trainer.train_factual_only(
            loader(args.caption_path, tcfg.caption_batch_size),
            loader(args.val_caption_path, tcfg.caption_batch_size,
                   train=False))
    elif args.trainer == "transfer":
        trainer = TransferTrainer(**common_kw)
        if args.checkpoint_path:
            # transfer loads the factual stage's PARAMETERS and builds fresh
            # optimizers over the style group (train_transfer.py:94-115)
            trainer.load_params(*common.load_decoder(args.checkpoint_path,
                                                     device))
        emo_train, emo_val = emo_paths[args.mode]
        trainer.train_transfer(
            loader(emo_train, tcfg.language_batch_size),
            loader(emo_val, tcfg.language_batch_size, train=False))
    else:  # paper
        trainer = PaperRegimeTrainer(**common_kw)

        def style_loader(path):
            ds = load_styled_caption_dataset(path, vocab)
            if args.device_resident:
                # text-only corpora always fit: (N, T) ids
                return device_data.from_styled(
                    ds, batch_size=tcfg.language_batch_size,
                    max_len=tcfg.max_caption_len, seed=args.seed,
                    device=device)
            return styled_caption_loader(
                ds, batch_size=tcfg.language_batch_size,
                max_len=tcfg.max_caption_len, seed=args.seed)

        trainer.train(
            loader(args.caption_path, tcfg.caption_batch_size),
            {emo: style_loader(p[0]) for emo, p in emo_paths.items()})
    common.end_parallel(mesh)


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import (add_data_flags, add_model_flags,
                                           add_parallel_flags,
                                           add_train_flags)

    p = argparse.ArgumentParser()
    p.add_argument("--trainer", type=str, default="multitask",
                   choices=["multitask", "multitask_att", "transfer_fac",
                            "transfer", "paper", "seq2seq"])
    p.add_argument("--family", type=str, default="stylenet",
                   choices=["stylenet", "nic"])
    p.add_argument("--attention", action="store_true")
    p.add_argument("--no_augment", action="store_true",
                   help="disable train-time crop/flip; use cached eval-mode "
                        "features")
    p.add_argument("--device_resident", action="store_true",
                   help="hold each split on the device and gather every "
                        "batch there, reading the losses once an epoch "
                        "(requires --no_augment or --feature_cache); "
                        "splits over the feature budget stream per-chunk "
                        "buffers instead")
    p.add_argument("--feature_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of --device_resident features; "
                        "bfloat16 halves the bytes (each gathered batch is "
                        "cast back to float32: the only difference is the "
                        "one-time storage rounding)")
    p.add_argument("--device_budget_gb", type=float,
                   default=DEVICE_BUDGET_GB,
                   help="device memory for --device_resident features: a "
                        "split whose unique features fit is pinned, a "
                        "larger one streams through two buffers of half "
                        "this size")
    add_parallel_flags(p, "training", multihost=True)
    p.add_argument("--checkpoint_path", type=str, default=None,
                   help="resume/fine-tune source checkpoint (a directory "
                        "the port's trainers wrote)")
    p.add_argument("--data_name", type=str, default="flickr8k_id")
    add_model_flags(p)
    add_train_flags(p)
    add_data_flags(p)
    return p


if __name__ == "__main__":
    args = parser().parse_args()
    print(args)
    main(args)
