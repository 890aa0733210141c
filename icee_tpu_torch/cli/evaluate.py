"""``python -m icee_tpu_torch.cli.evaluate`` — held-out-test BLEU evaluator
(reference ``stylenet/evaluator.py:59-139``; port of
``icee_tpu/cli/evaluate.py``): beam-decode every test line in ``--mode``,
print ref/pred pairs, report corpus BLEU-1..4 with cumulative weights.

The test set decodes in batches of ``--batch_size``, the last one padded to
the batch as the JAX CLI pads it: one K2 launch a batch
(``decode/fast.py::factored_decode("mega", ...)``), or with
``--attention`` one K7 launch a batch (``attention_decode("mega", ...)``);
on the CPU their plain versions.  The JAX CLI probes a chain of candidate
paths and takes the first that compiles; the port has one path a decoder,
which takes every beam width up to V.

``--data_parallel`` decodes each batch over every rank of the world (one
process per card, started by ``python -m torch.distributed.run``): each
rank searches its ``--batch_size / N`` images
(``decode/fast.py::sharded_factored_decode`` /
``sharded_attention_decode``) and rank 0 prints; ``--batch_size`` must
divide by N.  A world of one process decodes single-device with a
WARNING.

Semantics: without ``--attention`` the research ``sample()`` by default
(the feature never fed, ``stylenet/model.py:224-227``); ``--feed_feature``
gives the serving semantics (``app/backend/model.py:414-417``).

Parity note: like the reference, BLEU here is computed over raw id
sequences INCLUDING ``<start>``/``<end>`` (``evaluator.py:74-104`` — unlike
the trainers' validation BLEU which strips them).
"""

import argparse

import numpy as np


def padded_features(head, provider, names, batch_size: int, attention: bool,
                    device):
    """One batch's decoder inputs, zero rows appended up to
    ``batch_size``: the spatial grids (attention), or the pooled features
    through the encoder head."""
    import torch

    from icee_tpu_torch.models import encoder as enc_mod

    pooled = torch.from_numpy(np.stack([provider(n) for n in names])).to(
        device, torch.float32)
    feats = pooled if attention else enc_mod.encode_global_from_pooled(
        head, pooled)
    n = feats.shape[0]
    if n < batch_size:
        feats = torch.cat([feats, feats.new_zeros(
            (batch_size - n,) + tuple(feats.shape[1:]))])
    return feats


def beam_decode(dec_params, cfg, vocab, feats, style: int, k: int,
                attention: bool, feed_feature: bool, mesh=None):
    """One batch's beam search: one K2 (or, with ``attention``, K7) launch
    on the card, on this rank's images of it with a ``mesh``; -> (tokens,
    lengths) of the whole batch as numpy."""
    import torch

    from icee_tpu_torch.decode import fast

    batch = feats.shape[0]
    common = (batch, k, cfg.max_seq_length, vocab.start, vocab.end)
    with torch.no_grad():
        if attention:
            if mesh is not None:
                res = fast.sharded_attention_decode(
                    dec_params, feats.contiguous(), style, mesh, *common)
            else:
                res = fast.attention_decode("mega", dec_params,
                                            feats.contiguous(), style,
                                            *common)
        else:
            tiled = feats[:, None, :].expand(batch, k, feats.shape[1])
            tiled = tiled.contiguous() if feed_feature else None
            if mesh is not None:
                res = fast.sharded_factored_decode(dec_params, tiled, style,
                                                   mesh, *common)
            else:
                res = fast.factored_decode("mega", dec_params, tiled, style,
                                           *common)
    return res.tokens.cpu().numpy(), res.length.cpu().numpy()


def evaluate(dec_params, head, cfg, vocab, dataset, provider, mode_idx,
             batch_size=64, k=5, print_pairs=True, attention=False,
             feed_feature=False, device="cuda", mesh=None):
    """-> [BLEU-1, BLEU-2, BLEU-3, BLEU-4] over ``dataset``'s lines;
    ``mesh``: each batch decoded data-parallel, the pairs printed by rank
    0 alone."""
    from icee_tpu_torch.evaluation.bleu import bleu_1_to_4

    references, hypotheses = [], []
    for i in range(0, len(dataset), batch_size):
        chunk = dataset[i : i + batch_size]
        feats = padded_features(head, provider, [ex.image for ex in chunk],
                                batch_size, attention, device)
        toks, lens = beam_decode(dec_params, cfg, vocab, feats, mode_idx, k,
                                 attention, feed_feature, mesh)
        for b, ex in enumerate(chunk):
            refs = [list(map(int, r)) for r in ex.all_caption_ids]
            hyp = toks[b, : lens[b]].tolist()
            references.append(refs)
            hypotheses.append(hyp)
            if print_pairs and (mesh is None or mesh.is_writer):
                print("ref", " ".join(vocab.idx2word[w] for w in refs[0]))
                print("pred", " ".join(vocab.idx2word[w] for w in hyp))
    return bleu_1_to_4(references, hypotheses)


def main(args) -> None:
    from icee_tpu_torch.cli import common
    from icee_tpu_torch.core.config import mode_id
    from icee_tpu_torch.data.captions import load_caption_dataset
    from icee_tpu_torch.data.vocab import load_vocab

    device = common.device_of(args)
    mesh = common.data_parallel_mesh(args, device, "decoding")
    if mesh is not None:
        device = mesh.device
        if args.batch_size % mesh.n_data:
            raise SystemExit(f"--batch_size {args.batch_size} must divide "
                             f"by the data-axis size {mesh.n_data}")
    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab), attention=args.attention)
    dataset = load_caption_dataset(args.test_path, vocab)
    provider = common.make_feature_provider(args, spatial=args.attention)

    if args.checkpoint_path:
        dec, head = common.load_decoder(args.checkpoint_path, device)
    else:
        print("WARNING: no --checkpoint_path; random weights (smoke mode)")
        dec, head = common.smoke_weights(cfg, device, args.attention)

    b1, b2, b3, b4 = evaluate(dec, head, cfg, vocab, dataset, provider,
                              mode_id(args.mode), batch_size=args.batch_size,
                              attention=args.attention,
                              feed_feature=args.feed_feature, device=device,
                              mesh=mesh)
    if mesh is None or mesh.is_writer:
        print("BLEU-1", b1)
        print("BLEU-2", b2)
        print("BLEU-3", b3)
        print("BLEU-4", b4)
    common.end_parallel(mesh)


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_model_flags, add_parallel_flags

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--attention", action="store_true",
                   help="evaluate the attention decoder (reference "
                        "evaluator default)")
    add_parallel_flags(p, "decoding")
    p.add_argument("--feed_feature", action="store_true",
                   help="feed the image feature at beam step 1 (serving "
                        "semantics) instead of the reference research "
                        "sample() that ignores it")
    p.add_argument("--mode", type=str, default="factual")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--test_path", type=str, required=True)
    p.add_argument("--vocab_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--feature_cache", type=str, default=None)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=224)
    add_model_flags(p)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
