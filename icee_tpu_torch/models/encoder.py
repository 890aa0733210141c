"""Encoder head on pooled ResNet features (port of
``icee_tpu/models/encoder.py``).

Global ``EncoderCNN`` (``stylenet/model.py:11-27``): frozen ResNet-152 minus
fc -> Linear(2048 -> embed) -> BatchNorm1d(momentum=0.01).  Serving runs the
BatchNorm on its running statistics; training on the batch statistics, and
returns the head with its running statistics updated.
"""

from __future__ import annotations

import torch

from icee_tpu_torch.core import initializers as init
from icee_tpu_torch.core.config import EncoderConfig
from icee_tpu_torch.models import resnet


def init_head_params(generator: torch.Generator, cfg: EncoderConfig,
                     dtype=torch.float32, device="cpu") -> dict:
    """Linear(2048 -> embed) with torch default init + BatchNorm1d."""
    kw = dict(dtype=dtype, device=device)
    return {
        "linear_w": init.torch_linear_default(
            generator, (cfg.feature_size, cfg.embed_size), cfg.feature_size,
            **kw),
        "linear_b": init.torch_linear_default(
            generator, (cfg.embed_size,), cfg.feature_size, **kw),
        "bn": {
            "weight": torch.ones((cfg.embed_size,), **kw),
            "bias": torch.zeros((cfg.embed_size,), **kw),
            "running_mean": torch.zeros((cfg.embed_size,), **kw),
            "running_var": torch.ones((cfg.embed_size,), **kw),
        },
    }


def apply_head(head: dict, pooled: torch.Tensor, train: bool = False,
               bn_momentum: float = 0.01):
    """Linear + BatchNorm1d(momentum=0.01) (``model.py:26``).  Eval mode
    (the default) -> features (B, embed) on the running statistics;
    ``train=True`` -> (features, head with updated running statistics)."""
    x = pooled @ head["linear_w"] + head["linear_b"]
    if not train:
        return resnet.batch_norm(x, head["bn"], channel_axis=-1)
    out, new_bn = resnet.batch_norm_train(x, head["bn"], bn_momentum)
    new_head = dict(head)
    new_head["bn"] = new_bn
    return out, new_head


def encode_global_from_pooled(head: dict, pooled: torch.Tensor,
                              train: bool = False, bn_momentum: float = 0.01):
    """Head-only path on cached or freshly pooled backbone features; the
    return follows :func:`apply_head`."""
    return apply_head(head, pooled, train, bn_momentum)
