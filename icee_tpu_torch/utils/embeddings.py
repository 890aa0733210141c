"""Pretrained-embedding loading (a copy of ``icee_tpu/utils/embeddings.py``;
reference ``utils.py:5-48``, SURVEY D8 —
present in the reference but unused by its drivers; provided for parity).

``load_embeddings`` reads a GloVe-format text file (``word v1 v2 ...``) into
an array ordered by the vocabulary, initializing missing words uniformly
with bound ``sqrt(3/dim)`` like the reference's ``init_embedding``."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def init_embedding(shape: Tuple[int, int], rng: np.random.Generator
                   ) -> np.ndarray:
    bias = np.sqrt(3.0 / shape[1])
    return rng.uniform(-bias, bias, shape).astype(np.float32)


def load_embeddings(emb_file: str, word_map: Dict[str, int],
                    seed: int = 0) -> Tuple[np.ndarray, int]:
    """-> (embeddings (len(word_map), dim), dim)."""
    with open(emb_file, "r") as f:
        emb_dim = len(f.readline().split(" ")) - 1

    rng = np.random.default_rng(seed)
    embeddings = init_embedding((len(word_map), emb_dim), rng)

    with open(emb_file, "r") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            word = parts[0]
            if word not in word_map:
                continue
            vec = [float(x) for x in parts[1:] if x and not x.isspace()]
            embeddings[word_map[word]] = np.asarray(vec, np.float32)
    return embeddings, emb_dim
