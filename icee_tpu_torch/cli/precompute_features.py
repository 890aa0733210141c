"""``python -m icee_tpu_torch.cli.precompute_features`` — encode every
unique image ONCE into an npz feature cache (port of
``icee_tpu/cli/precompute_features.py``).

The reference recomputes the frozen ResNet-152 on every image every epoch
(SURVEY.md §7: caching is a free win): this tool writes the
``--feature_cache`` file that the train / evaluate / validate /
caption_batch CLIs read.  The port's ResNet-152 runs on the card (cuDNN) in
batches of ``--batch_size``, the last one padded to the batch.

Writes pooled (2048,) features by default, spatial ``(grid * grid, 2048)``
grids with ``--spatial`` (attention models), under the same npz keys as the
JAX CLI: the image names.
"""

import argparse
import os
import sys

import numpy as np


def main(args) -> None:
    import torch

    from icee_tpu_torch.cli.common import (device_of, load_resnet_params,
                                           tree_to)
    from icee_tpu_torch.data.captions import parse_caption_file
    from icee_tpu_torch.data.transforms import host_decode_resize, normalize
    from icee_tpu_torch.models import resnet
    from icee_tpu_torch.native import imagedec

    device = device_of(args)
    names = sorted({n for n, _ in parse_caption_file(args.caption_path)})
    print(f"{len(names)} unique images")

    backbone = resnet.Backbone(tree_to(load_resnet_params(
        args.resnet_weights, args.backbone_dtype), device))
    if args.resnet_weights is None:
        print("WARNING: no --resnet_weights; random backbone (smoke mode)")

    @torch.no_grad()
    def encode(imgs: np.ndarray) -> np.ndarray:
        x = normalize(torch.from_numpy(imgs).to(device))
        if args.spatial:
            return backbone.features(x, args.grid)[1].cpu().numpy()
        return backbone(x).cpu().numpy()

    # opt-in: the native resize is classic bilinear, not PIL's antialiased
    # filter, so the default stays on the torchvision-parity PIL path
    use_native = args.native_decode and imagedec.native_available()
    if use_native:
        print("native libjpeg batch feeder active (C++ threads)")
    elif args.native_decode:
        print("WARNING: --native_decode: the native JPEG decoder did not "
              "build here (it needs g++ and libjpeg's headers); decoding "
              "with PIL", file=sys.stderr)

    def load_chunk(chunk):
        jpeg_like = [n for n in chunk
                     if n.lower().endswith((".jpg", ".jpeg"))]
        if use_native and len(jpeg_like) == len(chunk):
            # C++ threaded decode+resize, one call per batch (no GIL)
            return imagedec.decode_resize_paths(
                [os.path.join(args.image_dir, n) for n in chunk],
                args.crop_size)
        return np.stack([
            host_decode_resize(os.path.join(args.image_dir, n),
                               args.crop_size)
            for n in chunk
        ])

    out = {}
    bs = args.batch_size
    for i in range(0, len(names), bs):
        chunk = names[i : i + bs]
        imgs = load_chunk(chunk)
        n = imgs.shape[0]
        if n < bs:  # pad to the batch, as the JAX CLI pads to its shape
            imgs = np.concatenate(
                [imgs, np.zeros((bs - n,) + imgs.shape[1:], imgs.dtype)])
        feats = encode(imgs)[:n]
        for name, f in zip(chunk, feats):
            out[name] = f
        print(f"  {min(i + bs, len(names))}/{len(names)}")
    np.savez(args.out, **out)
    print(f"wrote {len(out)} features to {args.out}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--caption_path", type=str, required=True,
                   help="caption file listing the images to encode")
    p.add_argument("--image_dir", type=str, required=True)
    p.add_argument("--out", type=str, default="features.npz")
    p.add_argument("--resnet_weights", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--spatial", action="store_true")
    p.add_argument("--grid", type=int, default=14)
    p.add_argument("--backbone_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="ResNet conv precision (bfloat16 conv operands, "
                        "float32 sums)")
    p.add_argument("--native_decode", action="store_true",
                   help="C++ libjpeg threaded batch feeder (faster; "
                        "classic bilinear resize instead of PIL's "
                        "antialiased filter)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device, e.g. cuda or cpu")
    return p


if __name__ == "__main__":
    main(parser().parse_args())
