"""ResNet-152 backbone, inference, and the BatchNorm's training mode (port
of ``icee_tpu/models/resnet.py``).

The reference uses torchvision's ``resnet152`` minus the fc layer, frozen
(``stylenet/model.py:15-24``).  The backbone is random He-normal init
(torchvision's default), weights moved across from the JAX package by
:mod:`icee_tpu_torch.bridge`, or a torchvision ``state_dict`` (``.pth`` or
``.npz``) through :func:`load_resnet_params`.

Layouts: every public function takes HWIO conv weights and NHWC images, as in
the JAX package.  :class:`Backbone` converts the conv weights to OIHW once, at
load, and runs NCHW convolutions on cuDNN (the JAX package leaves the convs to
XLA, outside any Pallas kernel); the serving engine holds one.  Padding is
torch's symmetric ``(k-1)//2``, not XLA "SAME".  BatchNorm uses running
statistics (eval).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

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
    """The conv in the WEIGHT dtype (the input is cast to it), returned as
    float32, as the JAX ``conv`` (``resnet.py:48-55``).  With bfloat16
    weights the JAX conv multiplies bfloat16 operands and accumulates in
    float32; the same arithmetic here is a float32 conv of the
    bfloat16-rounded operands (their products are exact in float32), since
    PyTorch's bfloat16 conv would round each output to bfloat16."""
    if padding is None:
        padding = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    return F.conv2d(x.to(w.dtype).float(), w.float(), stride=stride,
                    padding=padding)


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


def batch_norm_train(x: torch.Tensor, p: Dict[str, torch.Tensor],
                     momentum: float = 0.1, group=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """torch-semantics BatchNorm in training mode over the last (channel)
    axis: normalizes by the biased batch statistics and updates the running
    mean and the *unbiased* running variance (``icee_tpu/models/resnet.py::
    batch_norm``).  -> (out, p with the new running statistics, detached:
    they are state, not parameters).

    ``group``: the rows are this rank's share of a batch split evenly over
    a data group, and the statistics are the whole batch's, as GSPMD
    computes them: the sum for the mean, then the sum of squared
    deviations (JAX's ``jnp.var``), each summed over the group in both
    directions (the rows downstream differ by rank)."""
    axes = tuple(range(x.ndim - 1))
    if group is None:
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
        n = x.numel() // x.shape[-1]
    else:
        from torch.distributed import get_world_size

        from icee_tpu_torch.parallel.collectives import all_reduce_sum

        n = x.numel() // x.shape[-1] * get_world_size(group)
        mean = all_reduce_sum(x.sum(dim=axes), group) / n
        var = all_reduce_sum(((x - mean) ** 2).sum(dim=axes), group) / n
    unbiased = var * n / max(n - 1, 1)
    new_p = dict(p)
    new_p["running_mean"] = ((1 - momentum) * p["running_mean"]
                             + momentum * mean).detach()
    new_p["running_var"] = ((1 - momentum) * p["running_var"]
                            + momentum * unbiased).detach()
    inv = torch.rsqrt(var + 1e-5)
    return (x - mean) * inv * p["weight"] + p["bias"], new_p


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

    def features(self, images: torch.Tensor, grid: int = 14
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pooled (B, 2048) and flattened spatial (B, grid * grid, 2048)
        features from ONE pass: the mean and the adaptive pool of the same
        feature map, as the JAX serving engine's ``_features`` derives
        both (a second backbone pass per request was a reviewed fault)."""
        fmap = self.forward(images)
        spatial = adaptive_avg_pool(fmap, (grid, grid))
        return fmap.mean(dim=(1, 2)), spatial.reshape(
            fmap.shape[0], grid * grid, fmap.shape[-1]).contiguous()


def _bottleneck_train_bn(x: torch.Tensor, p: dict, stride: int,
                         momentum: float):
    """:func:`bottleneck` with every BatchNorm in training mode -> (out, p
    with the new running statistics)."""
    new_p = dict(p)
    out, new_p["bn1"] = batch_norm_train(conv(x, p["conv1"], 1), p["bn1"],
                                         momentum)
    out, new_p["bn2"] = batch_norm_train(conv(torch.relu(out), p["conv2"],
                                              stride), p["bn2"], momentum)
    out, new_p["bn3"] = batch_norm_train(conv(torch.relu(out), p["conv3"], 1),
                                         p["bn3"], momentum)
    if "downsample_conv" in p:
        identity, new_p["downsample_bn"] = batch_norm_train(
            conv(x, p["downsample_conv"], stride), p["downsample_bn"],
            momentum)
    else:
        identity = x
    return torch.relu(out + identity), new_p


def forward_train_bn(params: dict, images: torch.Tensor,
                     momentum: float = 0.1):
    """:func:`forward` with the BatchNorms on the batch statistics,
    updating their running statistics (``icee_tpu/models/resnet.py::
    forward(train_bn=True)``, the reference's frozen backbone left in
    training mode) -> (feature map (B, H/32, W/32, 2048) NHWC, params with
    the new running statistics)."""
    new_params = dict(params)
    x = conv(images, params["conv1"], 2, padding=(3, 3))
    x, new_params["bn1"] = batch_norm_train(x, params["bn1"], momentum)
    x = max_pool_3x3_s2(torch.relu(x))
    for li, nblocks in enumerate(LAYERS_152):
        layer = list(params[f"layer{li + 1}"])
        for bi in range(nblocks):
            x, layer[bi] = _bottleneck_train_bn(
                x, layer[bi], 2 if (bi == 0 and li > 0) else 1, momentum)
        new_params[f"layer{li + 1}"] = layer
    return x, new_params


def forward(params: dict, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) normalized NHWC -> feature map (B, H/32, W/32,
    2048) NHWC, from HWIO ``params``.  Converts the weights on every call:
    hold a :class:`Backbone` to convert them once."""
    return Backbone(params).forward(images)


def global_features(params: dict, images: torch.Tensor) -> torch.Tensor:
    """Pooled (B, 2048) features — global EncoderCNN path (model.py:22-26)."""
    return Backbone(params)(images)


def spatial_features(params: dict, images: torch.Tensor,
                     grid: int = 14) -> torch.Tensor:
    """(B, grid, grid, 2048) features — spatial EncoderCNN path
    (model_att.py:22-29)."""
    return adaptive_avg_pool(Backbone(params).forward(images), (grid, grid))


BACKBONE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast_conv_weights(params, dtype):
    """Cast only the CONV kernels to ``dtype`` (the bf16 backbone mode,
    ``icee_tpu/models/resnet.py::cast_conv_weights``); BatchNorm affine
    and running statistics stay float32, and every conv then takes
    ``dtype``-rounded operands with float32 sums and result
    (:func:`_conv`)."""
    if isinstance(params, dict):
        return {k: (v.to(dtype) if k.startswith(("conv", "downsample_conv"))
                    else cast_conv_weights(v, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_conv_weights(v, dtype) for v in params]
    return params


def backbone_dtype(name: str) -> torch.dtype:
    """``ServeConfig.backbone_dtype`` -> the conv weights' dtype: "float32"
    or "bfloat16"; anything else raises."""
    if name not in BACKBONE_DTYPES:
        raise ValueError(f"backbone_dtype {name!r}: choose one of "
                         f"{sorted(BACKBONE_DTYPES)}")
    return BACKBONE_DTYPES[name]


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


# --- torch checkpoints ------------------------------------------------------

def import_torch_state_dict(state_dict, dtype=torch.float32) -> dict:
    """torchvision ``resnet152().state_dict()`` -> the HWIO parameter tree
    (CPU tensors).  Conv weights transpose OIHW -> HWIO; BatchNorm tensors
    copy through.  Takes tensors or numpy arrays."""

    def arr(name):
        t = state_dict[name]
        a = t.detach().cpu().numpy() if hasattr(t, "detach") else t
        return torch.from_numpy(np.array(a, copy=True)).to(dtype)

    def conv_w(name):
        return arr(name).permute(2, 3, 1, 0).contiguous()

    def bn(prefix):
        return {k: arr(f"{prefix}.{k}")
                for k in ("weight", "bias", "running_mean", "running_var")}

    params = {"conv1": conv_w("conv1.weight"), "bn1": bn("bn1")}
    for li, nblocks in enumerate(LAYERS_152):
        blocks = []
        for bi in range(nblocks):
            pre = f"layer{li + 1}.{bi}"
            p = {
                "conv1": conv_w(f"{pre}.conv1.weight"),
                "bn1": bn(f"{pre}.bn1"),
                "conv2": conv_w(f"{pre}.conv2.weight"),
                "bn2": bn(f"{pre}.bn2"),
                "conv3": conv_w(f"{pre}.conv3.weight"),
                "bn3": bn(f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in state_dict:
                p["downsample_conv"] = conv_w(f"{pre}.downsample.0.weight")
                p["downsample_bn"] = bn(f"{pre}.downsample.1")
            blocks.append(p)
        params[f"layer{li + 1}"] = blocks
    return params


def load_resnet_params(path: Optional[str]) -> dict:
    """Backbone weights (CPU, HWIO) from a torch ``.pth`` (a state dict or a
    pickled module, read without its classes) or an ``.npz`` of the same
    names, or random init (seed 0) for ``None``; the port of the loader in
    ``icee_tpu/cli/common.py::load_resnet_params``.  A ``resnet.`` wrapper
    prefix (``EncoderCNN`` pickles) is stripped."""
    from icee_tpu_torch.checkpoint.torch_pickle import load_state_dict

    if path is None:
        return init_params(torch.Generator().manual_seed(0))
    if path.endswith(".npz"):
        with np.load(path) as f:
            return import_torch_state_dict(dict(f))
    sd = {k.removeprefix("resnet."): v
          for k, v in load_state_dict(path).items()}
    return import_torch_state_dict(sd)
