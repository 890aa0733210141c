"""Image transforms (port of ``icee_tpu/data/transforms.py``).

The reference composes torchvision transforms on the host per image
(``train_multitask.py:63-69``: Resize(336) -> RandomCrop(224) ->
RandomHorizontalFlip -> ToTensor -> ImageNet Normalize; the eval/serving
path is Resize(224) -> ToTensor -> Normalize, ``sample.py:26-30``).  The
host decodes and resizes with PIL (matching torchvision's bilinear resize);
the random crop and flip and the normalization run on the tensors' device.

Randomness: :func:`train_augment` draws each image's crop offsets and flip
coin from a ``torch.Generator``; :func:`crop_flip` applies given offsets and
flips, so that the tests can hand it the JAX package's ``jax.random`` draws,
which torch cannot reproduce.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def host_decode_resize(path_or_img, size: int) -> np.ndarray:
    """PIL decode + bilinear resize to (size, size, 3) uint8 — host side."""
    from PIL import Image

    img = path_or_img
    if not hasattr(img, "resize"):
        img = Image.open(img)
    img = img.convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8/float [0,255] NHWC -> ImageNet-normalized float32 NHWC."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def augment_draws(batch: int, height: int, width: int, crop_size: int,
                  generator: torch.Generator):
    """One batch's draws on the generator's device: crop offsets (batch, 2)
    [y, x], each from [0, dim - crop_size] inclusive (torchvision's
    RandomCrop), and flips (batch,) bool, one fair coin an image."""
    dev = generator.device
    off_y = torch.randint(0, height - crop_size + 1, (batch,),
                          generator=generator, device=dev)
    off_x = torch.randint(0, width - crop_size + 1, (batch,),
                          generator=generator, device=dev)
    flips = torch.rand((batch,), generator=generator, device=dev) < 0.5
    return torch.stack([off_y, off_x], 1), flips


def crop_flip(images: torch.Tensor, offsets, flips,
              crop_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) NHWC -> (B, crop_size, crop_size, 3), each image cropped
    at its [y, x] offset and mirrored left-right where its flip is set; the
    dtype stays (uint8 in, uint8 out)."""
    offsets = torch.as_tensor(offsets).tolist()
    flips = torch.as_tensor(flips).tolist()
    out = []
    for img, (y, x), flip in zip(images, offsets, flips):
        crop = img[y:y + crop_size, x:x + crop_size]
        out.append(crop.flip(1) if flip else crop)
    return torch.stack(out)


def train_augment(images: torch.Tensor, generator: torch.Generator,
                  crop_size: int = 224) -> torch.Tensor:
    """Batched RandomCrop + RandomHorizontalFlip + Normalize: (B, H, W, 3)
    uint8, already resized on the host, with a crop offset and a flip coin
    an image from ``generator`` -> normalized float32."""
    b, h, w, _ = images.shape
    offsets, flips = augment_draws(b, h, w, crop_size, generator)
    return normalize(crop_flip(images, offsets, flips, crop_size))


def eval_preprocess(images: torch.Tensor, crop_size: int = 224
                    ) -> torch.Tensor:
    """The deterministic path: images already resized to the crop size on
    the host (the reference's eval Resize(224), ``sample.py:26-30``), so
    only the normalization is left."""
    del crop_size
    return normalize(images)
