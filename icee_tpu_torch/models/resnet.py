"""ResNet-152 backbone, inference only (port of ``icee_tpu/models/resnet.py``).

The reference uses torchvision's ``resnet152`` minus the fc layer, frozen
(``stylenet/model.py:15-24``).  No pretrained weights exist offline, so the
backbone is random He-normal init (torchvision's default) or weights moved
across from the JAX package by :mod:`icee_tpu_torch.bridge`.

Layouts: every public function takes HWIO conv weights and NHWC images, as in
the JAX package.  :class:`Backbone` converts the conv weights to OIHW once, at
load, and runs NCHW convolutions on cuDNN (the JAX package leaves the convs to
XLA, outside any Pallas kernel); the serving engine holds one.  Padding is
torch's symmetric ``(k-1)//2``, not XLA "SAME".  BatchNorm uses running
statistics (eval).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

LAYERS_152 = (3, 8, 36, 3)
PLANES = (64, 128, 256, 512)
EXPANSION = 4


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def _convs_to_oihw(params):
    """HWIO conv weights -> contiguous OIHW; BatchNorm tensors pass through."""
    if isinstance(params, dict):
        return {k: (_oihw(v) if k.startswith(("conv", "downsample_conv"))
                    else _convs_to_oihw(v)) for k, v in params.items()}
    if isinstance(params, list):
        return [_convs_to_oihw(v) for v in params]
    return params


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# --- NCHW / OIHW internals (cuDNN's layout) ------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, stride: int,
          padding=None) -> torch.Tensor:
    if padding is None:
        padding = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    return F.conv2d(x.to(w.dtype), w, stride=stride, padding=padding).float()


def _bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    out = torch.relu(batch_norm(_conv(x, p["conv1"], 1), p["bn1"], 1))
    out = torch.relu(batch_norm(_conv(out, p["conv2"], stride), p["bn2"], 1))
    out = batch_norm(_conv(out, p["conv3"], 1), p["bn3"], 1)
    if "downsample_conv" in p:
        identity = batch_norm(_conv(x, p["downsample_conv"], stride),
                              p["downsample_bn"], 1)
    else:
        identity = x
    return torch.relu(out + identity)


# --- primitive layers (JAX layouts) --------------------------------------

def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         padding=None) -> torch.Tensor:
    """NHWC conv with HWIO weights; default padding is torch's symmetric
    ``(k-1)//2`` (``resnet.py:37``), else ``(pad_h, pad_w)``."""
    return _nhwc(_conv(_nchw(x), _oihw(w), stride, padding))


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               channel_axis: int = -1) -> torch.Tensor:
    """torch-semantics BatchNorm in eval mode (running statistics), with the
    JAX package's operation order."""
    shape = [1] * x.ndim
    shape[channel_axis] = -1

    def b(name):
        return p[name].reshape(shape)

    inv = torch.rsqrt(b("running_var") + 1e-5)
    return (x - b("running_mean")) * inv * b("weight") + b("bias")


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(kernel_size=3, stride=2, padding=1) on NHWC."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel_size=3, stride=2, padding=1))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` on an NHWC tensor."""
    return _nhwc(F.adaptive_avg_pool2d(_nchw(x), out_hw))


def bottleneck(x: torch.Tensor, p: dict, stride: int) -> torch.Tensor:
    """torchvision Bottleneck v1 (1x1 -> 3x3 stride -> 1x1 x4) + identity,
    on NHWC with HWIO weights."""
    return _nhwc(_bottleneck(_nchw(x), _convs_to_oihw(p), stride))


class Backbone:
    """ResNet-152 inference over a parameter tree in the JAX layout (HWIO,
    as :func:`init_params` and the bridge give it), with the conv weights
    converted to OIHW once, here, for cuDNN."""

    def __init__(self, params: dict):
        self.params = _convs_to_oihw(params)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) normalized NHWC -> feature map (B, H/32,
        W/32, 2048) NHWC."""
        p = self.params
        x = _conv(_nchw(images), p["conv1"], 2, padding=(3, 3))
        x = torch.relu(batch_norm(x, p["bn1"], 1))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for li, nblocks in enumerate(LAYERS_152):
            for bi, block in enumerate(p[f"layer{li + 1}"][:nblocks]):
                x = _bottleneck(x, block, 2 if (bi == 0 and li > 0) else 1)
        return _nhwc(x)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """Pooled (B, 2048) features — global EncoderCNN path
        (model.py:22-26)."""
        return self.forward(images).mean(dim=(1, 2))


def forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) normalized NHWC -> feature map (B, H/32, W/32,
    2048) NHWC, from HWIO ``params``.  Converts the weights on every call:
    hold a :class:`Backbone` to convert them once."""
    return Backbone(params).forward(images)


def global_features(params: dict, images: torch.Tensor) -> torch.Tensor:
    """Pooled (B, 2048) features — global EncoderCNN path (model.py:22-26)."""
    return Backbone(params)(images)


# --- init -----------------------------------------------------------------

def _bn_init(c: int, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {
        "weight": torch.ones((c,), **kw),
        "bias": torch.zeros((c,), **kw),
        "running_mean": torch.zeros((c,), **kw),
        "running_var": torch.ones((c,), **kw),
    }


def init_params(generator: torch.Generator, dtype=torch.float32,
                device="cpu") -> dict:
    """He-normal random init (torchvision's default conv init), HWIO."""

    def he(shape):
        fan_out = shape[0] * shape[1] * shape[3]
        w = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return (w * math.sqrt(2.0 / fan_out)).to(device)

    params = {"conv1": he((7, 7, 3, 64)), "bn1": _bn_init(64, dtype, device)}
    in_c = 64
    for li, nblocks in enumerate(LAYERS_152):
        planes = PLANES[li]
        out_c = planes * EXPANSION
        blocks = []
        for bi in range(nblocks):
            p = {
                "conv1": he((1, 1, in_c, planes)),
                "bn1": _bn_init(planes, dtype, device),
                "conv2": he((3, 3, planes, planes)),
                "bn2": _bn_init(planes, dtype, device),
                "conv3": he((1, 1, planes, out_c)),
                "bn3": _bn_init(out_c, dtype, device),
            }
            if bi == 0:
                p["downsample_conv"] = he((1, 1, in_c, out_c))
                p["downsample_bn"] = _bn_init(out_c, dtype, device)
            blocks.append(p)
            in_c = out_c
        params[f"layer{li + 1}"] = blocks
    return params
