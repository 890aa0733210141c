"""Serving-path image transforms (port of ``icee_tpu/data/transforms.py``'s
``host_decode_resize`` and ``normalize``; the training augmentations come
with the training slice).

The reference eval/serving path is Resize(224) -> ToTensor -> ImageNet
Normalize (``sample.py:26-30``).  The host decodes and resizes with PIL
(matching torchvision's bilinear resize); normalization runs on the device.
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
