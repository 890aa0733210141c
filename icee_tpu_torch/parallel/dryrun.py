"""The multi-rank dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): ``python -m icee_tpu_torch.parallel.dryrun N
[--device cuda|cpu]``, on the card unless ``--device cpu`` is given.

It spawns ``n`` ranks (:mod:`icee_tpu_torch.parallel.launch`) and on a
``dp_tp_shape(n, 2)`` mesh runs, at tiny widths with random weights:

- one ``MultitaskTrainer`` epoch of the global family (StyleNet: train,
  validation, BLEU, the sample caption, the checkpoint), then a pinned
  device split's train and validation passes;
- one ``MultitaskTrainer`` epoch of the attention family (StyleNet+Att);
- one SentiCap base epoch on a data-parallel ``(n, 1)`` mesh;
- a sharded K2 search and a sharded K7 search over the data axis.

Every rank's parameters must equal rank 0's after each trainer, and the
losses must be finite; rank 0 prints one summary line.  With ``--device
cuda`` (the default) the ranks share the cards (gloo where they share
one, NCCL where each has its own); with ``--device cpu`` the kernels run
their plain versions.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from icee_tpu_torch.parallel.launch import spawn

V, E, H, FEAT, P, T = 256, 16, 32, 24, 5, 10


def _vocab():
    from icee_tpu_torch.data.vocab import SPECIALS, Vocabulary

    vocab = Vocabulary()
    for s in SPECIALS:
        vocab.add_word(s)
    for i in range(V - len(SPECIALS)):
        vocab.add_word(f"w{i}")
    return vocab


def _batch(rng, vocab, b: int, feat_shape):
    from icee_tpu_torch.data.pipeline import CaptionBatch

    caps = np.zeros((b, T), np.int64)
    lens = rng.integers(4, T, (b,))
    for i in range(b):
        caps[i, 0] = vocab.start
        caps[i, 1:lens[i] - 1] = rng.integers(4, V, (lens[i] - 2,))
        caps[i, lens[i] - 1] = vocab.end
    return CaptionBatch(
        images=rng.standard_normal((b,) + feat_shape).astype(np.float32),
        captions=caps, lengths=lens, sample_mask=np.ones((b,), bool),
        references=[[list(c[:n])] for c, n in zip(caps, lens)])


def _same_on_every_rank(tree, mesh) -> None:
    """Raise unless every leaf equals rank 0's bit for bit."""
    from icee_tpu_torch.parallel.collectives import broadcast_
    from icee_tpu_torch.train.optim import tree_leaves

    for x in tree_leaves(tree):
        if x is None:
            continue
        ref = broadcast_(x.detach().clone(), 0)
        if not torch.equal(ref, x):
            raise RuntimeError(f"rank {mesh.rank} holds other parameters "
                               "than rank 0")


def _trainer_epoch(mesh, vocab, family: str, tmp: str, rng) -> dict:
    from icee_tpu_torch.core.config import (AttentionDecoderConfig,
                                            DecoderConfig, EncoderConfig,
                                            TrainConfig)
    from icee_tpu_torch.data.device import DeviceCaptionData
    from icee_tpu_torch.models import attention as att_mod
    from icee_tpu_torch.models import encoder as enc_mod
    from icee_tpu_torch.models import factored_lstm as fl
    from icee_tpu_torch.train.loops import MultitaskTrainer

    att = family.endswith("_att")
    dims = dict(vocab_size=V, embed_size=E, hidden_size=H, factored_size=H,
                feature_size=FEAT, max_seq_length=6)
    cfg = (AttentionDecoderConfig(attention_size=16, **dims) if att
           else DecoderConfig(**dims))
    tcfg = TrainConfig(mode="happy", teacher_forcing_ratio=1.0,
                       log_step=10_000, log_step_emotion=10_000,
                       chunked_ce=True, fused_scan=True,
                       caption_batch_size=8 * mesh.n_data,
                       language_batch_size=8 * mesh.n_data)
    gen = torch.Generator().manual_seed(0)
    dec = (att_mod.init_factored_att_params(gen, cfg) if att
           else fl.init_params(gen, cfg))
    head = None if att else enc_mod.init_head_params(
        torch.Generator().manual_seed(1),
        EncoderConfig(embed_size=E, feature_size=FEAT))
    b = 8 * mesh.n_data
    shape = (P, FEAT) if att else (FEAT,)
    loaders = [[_batch(rng, vocab, b, shape)] for _ in range(4)]
    tr = MultitaskTrainer(cfg, tcfg, vocab, dec, head, family=family,
                          model_dir=tmp, data_name=f"dryrun_{family}",
                          mesh=mesh, device=mesh.device)
    out = tr.train(*loaders, num_epochs=1)
    stats = {"best_bleu4": out["best_bleu4"]}
    if not att:
        bt = loaders[0][0]
        ddata = DeviceCaptionData(
            images=torch.from_numpy(bt.images).to(mesh.device),
            captions=torch.from_numpy(bt.captions).to(mesh.device),
            lengths=torch.from_numpy(bt.lengths).to(mesh.device),
            num_examples=b, batch_size=b, shuffle=False,
            references=bt.references)
        st = tr._run_train(ddata, 0, 10_000, "FAC")
        va = tr._run_val(ddata, 0)
        if not (np.isfinite(st.loss) and np.isfinite(va.loss)):
            raise RuntimeError("the device split's losses are not finite")
        stats["device_loss"] = st.loss
    stats["dec"] = tr._whole_dec()
    _same_on_every_rank((stats["dec"], tr.head), mesh)
    return stats


def _senticap_epoch(mesh, rng) -> float:
    from icee_tpu_torch.senticap import io as sio
    from icee_tpu_torch.senticap.config import senticap_conf
    from icee_tpu_torch.senticap.train import train_base

    words = [f"w{i}" for i in range(40)]
    recs = [{"image": f"img{i}", "tokens": list(rng.choice(words, 6)),
             "sentiment": 1.0} for i in range(8 * mesh.n_data)]
    feats = {r["image"]: rng.standard_normal(12).astype(np.float32)
             for r in recs}
    w2i, _ = sio.build_vocab([r["tokens"] for r in recs], min_freq=1)
    conf = senticap_conf(emb_size=16, lstm_hidden_size=16, visual_size=12,
                         MAX_SENTENCE_LEN=8, batch_size_val=4 * mesh.n_data,
                         CHUNKED_CE=True, FUSED_SCAN=True)
    ds = sio.make_split(recs, feats, w2i, 8, 12)
    params, _ = train_base(ds, len(w2i), conf, num_epochs=1, seed=0,
                           mesh=mesh, device=mesh.device)
    _same_on_every_rank(params, mesh)
    return len(w2i)


def _decodes(mesh, decs: dict, rng) -> tuple:
    from icee_tpu_torch.decode.fast import (sharded_attention_decode,
                                            sharded_factored_decode)

    b, k = 4 * mesh.n_data, 3
    with torch.no_grad():
        feats = torch.from_numpy(rng.standard_normal(
            (b, k, E)).astype(np.float32)).to(mesh.device)
        k2 = sharded_factored_decode(decs["factored"], feats, 1, mesh, b, k,
                                     6, 1, 2)
        spatial = torch.from_numpy(rng.standard_normal(
            (b, P, FEAT)).astype(np.float32)).to(mesh.device)
        k7 = sharded_attention_decode(decs["factored_att"], spatial, 1, mesh,
                                      b, k, 6, 1, 2)
    return tuple(k2.tokens.shape), tuple(k7.tokens.shape)


def _rank(mesh, payload) -> str:
    from icee_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)         # the same draws on every rank
    vocab = _vocab()
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        for family in ("factored", "factored_att"):
            stats[family] = _trainer_epoch(mesh, vocab, family, tmp, rng)
    dp = mesh if mesh.n_model == 1 else make_mesh((mesh.n_data *
                                                   mesh.n_model, 1),
                                                  device=mesh.device)
    n_words = _senticap_epoch(dp, rng)
    k2, k7 = _decodes(mesh, {f: s["dec"] for f, s in stats.items()}, rng)
    return (f"dryrun_multichip OK: {mesh.n_data * mesh.n_model} ranks, mesh "
            f"{mesh.shape}, StyleNet epoch (best_bleu4 "
            f"{stats['factored']['best_bleu4']}, device split loss "
            f"{stats['factored']['device_loss']:.4f}), StyleNet+Att epoch, "
            f"SentiCap base DP epoch ({n_words} words), sharded K2 {k2}, "
            f"sharded K7 {k7}; parameters equal on every rank")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend=None) -> str:
    """Run the dry run on ``n_devices`` spawned ranks -> rank 0's summary
    line (each rank raises on a fault)."""
    from icee_tpu_torch.parallel.train import dp_tp_shape

    shape = dp_tp_shape(n_devices, tp=2)
    if backend is None and device == "cuda" and \
            torch.cuda.device_count() < n_devices:
        backend = "gloo"                     # ranks share a card
    with tempfile.TemporaryDirectory() as work:
        lines = spawn(_rank, n_devices, None, workdir=work, shape=shape,
                      device=device, backend=backend)
    return lines[0]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    args = p.parse_args()
    print(dryrun_multichip(args.n, args.device, args.dist_backend))


if __name__ == "__main__":
    main()
