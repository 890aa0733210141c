"""``python -m icee_tpu_torch.cli.validate`` — standalone validation pass
(reference ``stylenet/validate.py``, SURVEY E2; port of
``icee_tpu/cli/validate.py``): teacher-forced loss + top-5 accuracy over a
split — the free-running forward, as the JAX CLI runs it — plus a batched
GREEDY sample per image scored with corpus BLEU-4 against all references.
Everything runs on the CLI's device; no kernel is involved (JAX computes
this pass in XLA)."""

import argparse

import numpy as np


def main(args) -> None:
    import torch

    from icee_tpu_torch.cli import common
    from icee_tpu_torch.core.config import mode_id
    from icee_tpu_torch.data.captions import load_caption_dataset
    from icee_tpu_torch.data.pipeline import caption_dataset_loader
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.decode.greedy import greedy_decode
    from icee_tpu_torch.evaluation.bleu import corpus_bleu
    from icee_tpu_torch.evaluation.metrics import (AverageMeter,
                                                   masked_cross_entropy,
                                                   masked_top_k_accuracy,
                                                   perplexity)
    from icee_tpu_torch.models import encoder as enc_mod
    from icee_tpu_torch.models import factored_lstm as fl
    from icee_tpu_torch.train.loops import strip_specials

    device = common.device_of(args)
    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    provider = common.make_feature_provider(args)
    ds = load_caption_dataset(args.caption_path, vocab)
    loader = caption_dataset_loader(ds, batch_size=args.batch_size,
                                    max_len=cfg.max_seq_length + 2,
                                    image_provider=provider, shuffle=False)

    if args.checkpoint_path:
        dec, head = common.load_decoder(args.checkpoint_path, device)
    else:
        print("WARNING: random weights (smoke mode)")
        dec, head = common.smoke_weights(cfg, device)

    style = mode_id(args.mode)

    @torch.no_grad()
    def val_batch(pooled, captions, lengths, smask):
        feats = enc_mod.encode_global_from_pooled(head, pooled)
        logits = fl.forward(dec, cfg, captions, feats, style,
                            teacher_forcing_ratio=0.0, train=False)
        loss = masked_cross_entropy(logits, captions, lengths, smask)
        top5 = masked_top_k_accuracy(logits, captions, lengths, 5, smask)
        # the feature is step 0's input, the argmax token's embedding after
        ids = greedy_decode(
            embed_fn=lambda t: fl.embed(dec, t),
            step_fn=lambda x, s: fl.decode_step(dec, x, s, style),
            init_state=fl.initial_state(pooled.shape[0], cfg, device=device),
            first_input=feats, max_steps=cfg.max_seq_length)
        return loss, top5, ids

    def on_device(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    losses, top5s = AverageMeter(), AverageMeter()
    references, hypotheses = [], []
    end = vocab.end
    for batch in loader:
        loss, top5, ids = val_batch(
            on_device(batch.images, torch.float32),
            on_device(batch.captions, torch.long),
            on_device(batch.lengths, torch.long),
            on_device(batch.sample_mask, torch.bool))
        n = int(batch.lengths.sum())
        losses.update(float(loss), n)
        top5s.update(float(top5), n)
        ids = ids.cpu().numpy()
        for b in range(batch.batch_size):
            if not batch.sample_mask[b]:
                continue
            references.append([strip_specials(r, vocab.start, end)
                               for r in batch.references[b]])
            hyp = []
            for w in ids[b].tolist():
                if w == end:
                    break
                hyp.append(w)
            hypotheses.append(hyp)
    bleu4 = corpus_bleu(references, hypotheses)
    print(f"Val Loss {losses.avg:.4f} | Perplexity "
          f"{perplexity(losses.avg):.4f} | Top-5 {top5s.avg:.3f} | "
          f"BLEU-4 {bleu4}")


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_model_flags

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--mode", type=str, default="factual")
    p.add_argument("--caption_path", type=str, required=True)
    p.add_argument("--vocab_path", type=str, required=True)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--feature_cache", type=str, default=None)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=64)
    add_model_flags(p)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
