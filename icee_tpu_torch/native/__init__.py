"""Flat ragged storage of encoded captions (port of
``icee_tpu/native/__init__.py``'s ``RaggedCaptions``, its NumPy path).

A corpus is encoded once into one flat int32 stream plus prefix offsets and
reused every epoch (the reference re-tokenizes text in DataLoader workers
each epoch).  The JAX package also has a threaded C++ batcher with the same
results; the port's batches come from NumPy until that batcher is ported.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class RaggedCaptions:
    """Flat ragged storage of encoded captions: ``data`` (total_tokens,)
    int32, ``offsets`` (n+1,) int64."""

    def __init__(self, caption_ids: Sequence[Sequence[int]]) -> None:
        lengths = np.asarray([len(c) for c in caption_ids], np.int64)
        self.offsets = np.zeros(len(caption_ids) + 1, np.int64)
        np.cumsum(lengths, out=self.offsets[1:])
        self.data = np.empty(int(self.offsets[-1]), np.int32)
        for i, c in enumerate(caption_ids):
            self.data[self.offsets[i]:self.offsets[i + 1]] = c

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def batch(self, indices: np.ndarray, max_len: int, pad_id: int = 0):
        """-> (captions (n, max_len) int32, lengths (n,) int32); captions
        longer than ``max_len`` are cut."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        captions = np.full((n, max_len), pad_id, np.int32)
        lengths = np.empty((n,), np.int32)
        for i, row in enumerate(indices):
            seq = self.data[self.offsets[row]:self.offsets[row + 1]][:max_len]
            captions[i, : len(seq)] = seq
            lengths[i] = len(seq)
        return captions, lengths

    def token_counts(self, vocab_size: int) -> np.ndarray:
        """(vocab_size,) int64 histogram of the ids in [0, vocab_size)."""
        return np.bincount(
            self.data[(self.data >= 0) & (self.data < vocab_size)],
            minlength=vocab_size).astype(np.int64)
