"""``python -m icee_tpu_torch.cli.caption_batch`` — throughput batch
captioning (port of ``icee_tpu/cli/caption_batch.py``).

Captions EVERY image in a directory (or a feature cache) in one run and
emits one JSON object ``{image: caption}``: the checkpoint loads once, the
backbone runs on the device, and each batch of ``--batch_size`` images
(the last one padded to the batch) decodes in one K2 launch, or with
``--attention`` one K7 launch (their plain versions on the CPU; a batch of more than
1,024 beam rows, e.g. 64 images at ``--beam_size`` 20, in several; above
1,024 one image a launch).  Every ``--beam_size`` up to V decodes on the
card; nothing decodes on a plain path there instead.

``--data_parallel`` decodes each batch over every rank of the world (one
process per card, ``python -m torch.distributed.run``): each rank searches
its share of the batch, rounded down to a multiple of the ranks (at least
one image each), as the JAX CLI rounds it, and rank 0 writes the JSON.  A
world of one process decodes single-device with a WARNING.

Serving semantics by default (image feature fed at beam step 1,
``app/backend/model.py:414-417``); ``--research_semantics`` gives the
``stylenet/model.py:224-227`` behavior.
"""

import argparse
import json
import os
import sys

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def caption_batch(dec_params, head, cfg, vocab, names, provider, mode_idx,
                  batch_size=64, k=5, attention=False, feed_feature=True,
                  device="cuda", mesh=None):
    """-> dict image name -> detokenized caption (serving detok contract:
    strip specials, drop trailing ``<unk>``,
    ``app/backend/sample.py:82-96``); ``mesh``: data-parallel decoding."""
    from icee_tpu_torch.cli.evaluate import beam_decode, padded_features

    batch_size = min(batch_size, max(1, len(names)))
    if mesh is not None:
        batch_size = max(mesh.n_data, batch_size - batch_size % mesh.n_data)
    out = {}
    for i in range(0, len(names), batch_size):
        chunk = names[i : i + batch_size]
        feats = padded_features(head, provider, chunk, batch_size, attention,
                                device)
        toks, lens = beam_decode(dec_params, cfg, vocab, feats, mode_idx, k,
                                 attention, feed_feature, mesh)
        for b, name in enumerate(chunk):
            words = vocab.decode(toks[b, : int(lens[b])])
            while words and words[-1] == "<unk>":
                words.pop()
            out[name] = " ".join(words)
    return out


def image_names(args) -> list:
    """The images to caption: ``--image_dir``'s image files (each of which
    must be in ``--feature_cache`` when both are given, checked before any
    decode), else the cache's names."""
    if args.feature_cache and not os.path.exists(args.feature_cache):
        raise SystemExit(f"feature cache not found: {args.feature_cache}")
    cache_files = None
    if args.feature_cache:
        with np.load(args.feature_cache) as f:
            cache_files = set(f.files)
    if args.image_dir:
        names = sorted(
            f for f in os.listdir(args.image_dir)
            if f.lower().endswith(IMAGE_EXTS))
        if cache_files is not None:
            # the provider serves from the cache, so a directory image
            # missing there would KeyError mid-run; validate up front
            missing = [n for n in names if n not in cache_files]
            if missing:
                raise SystemExit(
                    f"{len(missing)} image(s) in --image_dir are absent "
                    f"from --feature_cache (first: {missing[0]}); "
                    "re-run precompute_features or drop --feature_cache")
    elif cache_files is not None:
        names = sorted(cache_files)
    else:
        raise SystemExit("need --image_dir or --feature_cache")
    if not names:
        raise SystemExit("no images found")
    return names


def main(args) -> None:
    from icee_tpu_torch.cli import common
    from icee_tpu_torch.core.config import mode_id
    from icee_tpu_torch.data.vocab import load_vocab

    device = common.device_of(args)
    mesh = common.data_parallel_mesh(args, device, "decoding")
    if mesh is not None:
        device = mesh.device
    vocab = load_vocab(args.vocab_path)
    cfg = common.decoder_config(args, len(vocab), attention=args.attention)
    names = image_names(args)
    provider = common.make_feature_provider(args, spatial=args.attention)

    if args.checkpoint_path:
        dec, head = common.load_decoder(args.checkpoint_path, device)
    else:
        print("WARNING: no --checkpoint_path; random weights (smoke mode)",
              file=sys.stderr)
        dec, head = common.smoke_weights(cfg, device, args.attention)

    captions = caption_batch(
        dec, head, cfg, vocab, names, provider, mode_id(args.mode),
        batch_size=args.batch_size, k=args.beam_size,
        attention=args.attention, feed_feature=not args.research_semantics,
        device=device, mesh=mesh)
    common.end_parallel(mesh)
    if mesh is not None and not mesh.is_writer:
        return
    text = json.dumps(captions, ensure_ascii=False, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {len(captions)} captions to {args.out}")
    else:
        print(text)


def parser() -> argparse.ArgumentParser:
    from icee_tpu_torch.cli.common import add_model_flags, add_parallel_flags

    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--attention", action="store_true",
                   help="use the attention decoder family")
    add_parallel_flags(p, "decoding")
    p.add_argument("--research_semantics", action="store_true",
                   help="ignore the image feature in the beam "
                        "(stylenet/model.py:224-227) instead of the "
                        "serving step-1 feed")
    p.add_argument("--mode", type=str, default="factual")
    p.add_argument("--image_dir", type=str, default=None)
    p.add_argument("--out", type=str, default=None,
                   help="output JSON path (default: stdout)")
    p.add_argument("--vocab_path", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--feature_cache", type=str, default=None)
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=224)
    add_model_flags(p)
    return p


if __name__ == "__main__":
    main(parser().parse_args())
