"""Training/validation metrics with packed-semantics parity (port of
``icee_tpu/evaluation/metrics.py``).

The reference computes every loss/metric over the *packed* token stream
(``CrossEntropyLoss`` default mean over tokens, ``train_multitask.py:300``;
top-5 accuracy over packed positions, ``utils.py:127-140``).  Batches here
are fixed-shape padded tensors, so each metric is mask-weighted with exactly
the packed normalization: sum over valid positions / number of valid tokens.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from icee_tpu_torch.decode.beam import top_k


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool validity mask (t < length)."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def _mask(lengths, max_len, sample_mask):
    mask = length_mask(lengths, max_len)
    if sample_mask is not None:
        mask = mask & sample_mask[:, None].bool()
    return mask


def masked_cross_entropy(
    logits: torch.Tensor,     # (B, T, V)
    targets: torch.Tensor,    # (B, T) int
    lengths: torch.Tensor,    # (B,)
    sample_mask: Optional[torch.Tensor] = None,  # (B,) bool, batch padding
) -> torch.Tensor:
    """Token-mean CE == torch ``CrossEntropyLoss()(packed_logits,
    packed_tgts)``."""
    mask = _mask(lengths, logits.shape[1], sample_mask)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / denom


def masked_top_k_accuracy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    lengths: torch.Tensor,
    k: int = 5,
    sample_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Top-k token accuracy in percent over valid tokens (utils.py:127-140);
    ties go to the lowest index, as ``lax.top_k``."""
    mask = _mask(lengths, logits.shape[1], sample_mask)
    _, top_idx = top_k(logits, k)                       # (B, T, k)
    correct = (top_idx == targets.long()[..., None]).any(dim=-1)
    denom = mask.sum().clamp(min=1)
    return 100.0 * (mask & correct).sum() / denom


def perplexity(mean_loss) -> float:
    """exp of the token-mean CE (``train_multitask.py:212``)."""
    return float(np.exp(float(mean_loss)))


class AverageMeter:
    """Running val/avg/sum/count tracker (reference ``utils.py:93-111``)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
