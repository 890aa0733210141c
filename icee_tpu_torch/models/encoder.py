"""Encoder head on pooled ResNet features, eval mode (port of
``icee_tpu/models/encoder.py``).

Global ``EncoderCNN`` (``stylenet/model.py:11-27``): frozen ResNet-152 minus
fc -> Linear(2048 -> embed) -> BatchNorm1d(momentum=0.01).  Serving runs the
BatchNorm on its running statistics.
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


def apply_head(head: dict, pooled: torch.Tensor) -> torch.Tensor:
    """Linear + BatchNorm1d on running statistics (``model.py:26``, eval)."""
    x = pooled @ head["linear_w"] + head["linear_b"]
    return resnet.batch_norm(x, head["bn"], channel_axis=-1)


def encode_global_from_pooled(head: dict, pooled: torch.Tensor) -> torch.Tensor:
    """Head-only path on cached or freshly pooled backbone features."""
    return apply_head(head, pooled)
