"""Typed configuration objects (copy of ``icee_tpu/core/config.py``'s
``MODES``, ``EMOTIONS``, ``mode_id``, ``EncoderConfig``, ``DecoderConfig``,
``AttentionDecoderConfig``, ``Seq2SeqConfig`` and ``TrainConfig``).

Default values mirror the reference defaults: ``embed 300 / hidden 512 /
factored 512 / dropout 0.5`` (``stylenet/train_multitask.py:621-625``) and
beam decode with ``max_seq_length=40`` (``stylenet/model.py:41,202``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Style modes, in the reference's fixed order; ``factual`` is index 0.
MODE_FACTUAL = "factual"
MODE_HAPPY = "happy"
MODE_SAD = "sad"
MODE_ANGRY = "angry"
MODES: Tuple[str, ...] = (MODE_FACTUAL, MODE_HAPPY, MODE_SAD, MODE_ANGRY)
EMOTIONS: Tuple[str, ...] = (MODE_HAPPY, MODE_SAD, MODE_ANGRY)


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


@dataclasses.dataclass(frozen=True)
class AttentionDecoderConfig(DecoderConfig):
    """Attention variants (``stylenet/model_att.py:73-426``,
    ``nic/model_att.py:73-306``)."""

    attention_size: int = 512

    @property
    def input_size(self) -> int:
        # [word_emb ; gated 2048-dim context] per step
        return self.embed_size + self.feature_size


@dataclasses.dataclass(frozen=True)
class Seq2SeqConfig:
    """Seq2seq style transfer (``seq2seq/model.py:220-301``)."""

    vocab_size: int = 0
    embed_size: int = 300
    hidden_size: int = 512
    num_layers: int = 1
    dropout: float = 0.22
    max_seq_length: int = 40
    feature_size: int = 2048


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training regime (multitask / transfer / seq2seq); the JAX
    package's fields and defaults."""

    mode: str = MODE_HAPPY            # which emotion track to co-train
    num_epochs: int = 120
    caption_batch_size: int = 64
    language_batch_size: int = 96
    lr_caption: float = 2e-4
    lr_language: float = 5e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip: float = 0.5            # elementwise clamp, utils.py:51-60
    teacher_forcing_ratio: float = 0.8
    lr_decay_factor: float = 0.8      # x0.8 every 4 plateau epochs
    lr_decay_patience: int = 4
    early_stop_patience: int = 10
    # Fixed padded caption length: max_seq_length + <start> + <end>.
    max_caption_len: int = 42
    seed: int = 0
    log_step: int = 50
    log_step_emotion: int = 5
    alpha_c: float = 1.0              # attention regularizer weight
    resize_size: int = 336
    crop_size: int = 224
    # The training scan through the hand-written CUDA kernels: K3
    # (ops/lstm_scan.py, StyleNet) and K4 (ops/nic_scan.py, NIC) on the
    # teacher-forced path; K5 (ops/att_scan.py, StyleNet+Att and NIC+Att)
    # teacher-forced and scheduled-sampling.  None = on when the tensors
    # are on CUDA; on the CPU the kernels' plain versions run.
    fused_scan: Optional[bool] = None
    # The training CE in time chunks from the hidden states
    # (ops/chunked_loss.py): the (B, T, V) logits never exist whole.
    # None = on when the tensors are on CUDA.
    chunked_ce: Optional[bool] = None
    # Mid-epoch progress checkpoints of the device-resident epochs; the
    # port's trainer refuses any value but 0 until those epochs are ported.
    progress_chunk: int = 0
