"""Typed configuration objects (copy of ``icee_tpu/core/config.py``'s serving
subset: ``MODES``, ``mode_id``, ``EncoderConfig``, ``DecoderConfig``).

Default values mirror the reference defaults: ``embed 300 / hidden 512 /
factored 512 / dropout 0.5`` (``stylenet/train_multitask.py:621-625``) and
beam decode with ``max_seq_length=40`` (``stylenet/model.py:41,202``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Style modes, in the reference's fixed order; ``factual`` is index 0.
MODE_FACTUAL = "factual"
MODE_HAPPY = "happy"
MODE_SAD = "sad"
MODE_ANGRY = "angry"
MODES: Tuple[str, ...] = (MODE_FACTUAL, MODE_HAPPY, MODE_SAD, MODE_ANGRY)


def mode_id(mode: str) -> int:
    """Integer id of a style mode (index into the stacked style weights)."""
    try:
        return MODES.index(mode)
    except ValueError:
        raise ValueError(f"mode name wrong! got {mode!r}, want one of {MODES}")


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """CNN encoder (reference ``EncoderCNN``, ``stylenet/model.py:11-27``)."""

    embed_size: int = 300
    feature_size: int = 2048          # ResNet-152 final channel count
    spatial: bool = False
    encoded_image_size: int = 14
    bn_momentum: float = 0.01         # BatchNorm1d(momentum=0.01) on the head
    image_size: int = 224
    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """StyleNet FactoredLSTM decoder (``stylenet/model.py:30-294``)."""

    vocab_size: int = 0               # filled from the built vocabulary
    embed_size: int = 300
    hidden_size: int = 512
    factored_size: int = 512
    num_layers: int = 1
    num_styles: int = 4               # factual + happy + sad + angry
    feature_size: int = 2048
    dropout: float = 0.5
    max_seq_length: int = 40
    factored: bool = True

    @property
    def input_size(self) -> int:
        return self.embed_size
