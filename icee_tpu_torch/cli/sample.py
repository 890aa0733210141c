"""``python -m icee_tpu_torch.cli.sample`` — single-image captioning CLI
(reference ``stylenet/sample.py:24-71``; port of ``icee_tpu/cli/sample.py``).

Loads a vocab + decoder (a checkpoint directory that the port's trainers
wrote, or a reference torch state dict or module pickle through the port's
importers), encodes the image, beam-decodes it in ``--mode`` and prints the
detokenized caption.  The JAX CLI decodes with its XLA ``beam_search``; the
port's plain ``decode/beam.py::beam_search`` computes what K2 computes, so
on a CUDA device the image decodes through ``factored_decode("mega", ...)``
at batch 1 — one K2 launch, as the trainers' per-validation sample — and on
the CPU through K2's plain version.
"""

import argparse
import os

import numpy as np


def caption_image(dec_params, cfg, vocab, feature, mode_idx, k=5,
                  feed_feature=True):
    """One image's caption: ``feature`` (E,) is the step-1 input (with
    ``feed_feature``), the words up to ``<end>``, ``<start>`` dropped."""
    import torch

    from icee_tpu_torch.decode.fast import factored_decode

    feat = torch.as_tensor(feature)
    feats = feat[None, None, :].expand(1, k, feat.shape[0]).contiguous()
    with torch.no_grad():
        res = factored_decode("mega", dec_params,
                              feats if feed_feature else None, int(mode_idx),
                              1, k, cfg.max_seq_length, vocab.start,
                              vocab.end)
    ids = res.tokens[0].cpu().numpy()[: int(res.length[0])]
    words = []
    for wid in ids:
        word = vocab.idx2word[int(wid)]
        if word == "<end>":
            break
        words.append(word)
    return " ".join(w for w in words if w != "<start>")


def load_weights(args, cfg, device):
    """(decoder, head) from ``--decoder_path`` / ``--encoder_path``: a port
    checkpoint directory or a reference torch checkpoint each; random
    (smoke mode) where a path is not given."""
    from icee_tpu_torch.checkpoint import torch_import as ti
    from icee_tpu_torch.checkpoint.torch_pickle import load_state_dict
    from icee_tpu_torch.cli import common
    from icee_tpu_torch.serve.engine import TORCH_CKPT

    dec, head = common.smoke_weights(cfg, device)
    if args.decoder_path and args.decoder_path.endswith(TORCH_CKPT):
        dec = common.tree_to(ti.import_factored_decoder_state_dict(
            load_state_dict(args.decoder_path)), device)
    elif args.decoder_path:
        dec = common.load_decoder(args.decoder_path, device)[0]
    else:
        print("WARNING: no --decoder_path; random decoder (smoke mode)")
    if args.encoder_path and args.encoder_path.endswith(TORCH_CKPT):
        sd = load_state_dict(args.encoder_path)
        head = common.tree_to(ti.import_encoder_head_state_dict(
            {k: v for k, v in sd.items() if not k.startswith("resnet.")}),
            device)
    elif args.encoder_path:
        head = common.load_decoder(args.encoder_path, device)[1]
    return dec, head


def main(args) -> None:
    import torch

    from icee_tpu_torch.cli import common
    from icee_tpu_torch.core.config import mode_id
    from icee_tpu_torch.data.vocab import load_vocab
    from icee_tpu_torch.models import encoder as enc_mod

    device = common.device_of(args)
    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab))
    dec, head = load_weights(args, cfg, device)

    args.image_dir = args.image_dir or os.path.dirname(args.image) or "."
    provider = common.make_feature_provider(args)
    pooled = torch.from_numpy(np.asarray(
        provider(os.path.basename(args.image)))).to(device, torch.float32)
    with torch.no_grad():
        feature = enc_mod.encode_global_from_pooled(head, pooled[None])
    print(caption_image(dec, cfg, vocab, feature[0], mode_id(args.mode)))


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_model_flags

    p = argparse.ArgumentParser()
    p.add_argument("--image", type=str, required=True,
                   help="input image for generating caption")
    p.add_argument("--encoder_path", type=str, default=None,
                   help="path for trained encoder")
    p.add_argument("--decoder_path", type=str, default=None,
                   help="path for trained decoder")
    p.add_argument("--vocab_path", type=str, default="data/vocab.pkl")
    p.add_argument("--mode", type=str, default="factual")
    add_model_flags(p)
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--feature_cache", type=str, default=None)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=224)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
