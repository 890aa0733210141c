"""Vocabulary with reference parity (copy of ``icee_tpu/data/vocab.py``).

Special tokens ``<pad>=0, <start>=1, <end>=2, <unk>=3``; unknown words fall
back to ``<unk>``; the vocabulary keeps corpus insertion order of words with
frequency >= threshold (``stylenet/build_vocab.py:7-61``).

:func:`load_vocab` reads three kinds of pickle without importing the module
that wrote them: this package's, the JAX package's
(``icee_tpu.data.vocab.Vocabulary``) and the reference's
(``build_vocab.Vocabulary`` and the copies in every family dir).
"""

from __future__ import annotations

import json
import pickle
from collections import Counter
from typing import Dict, Iterable, List

from icee_tpu_torch.data.tokenize import word_tokenize

PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"
SPECIALS = (PAD, START, END, UNK)


class Vocabulary:
    """word<->idx map; unknown words map to ``<unk>`` (build_vocab.py:21-24)."""

    def __init__(self) -> None:
        self.word2idx: Dict[str, int] = {}
        self.idx2word: Dict[int, str] = {}
        self.idx = 0

    def add_word(self, word: str) -> None:
        if word not in self.word2idx:
            self.word2idx[word] = self.idx
            self.idx2word[self.idx] = word
            self.idx += 1

    def __call__(self, word: str) -> int:
        if word not in self.word2idx:
            return self.word2idx[UNK]
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.word2idx)

    @property
    def pad(self) -> int:
        return self.word2idx[PAD]

    @property
    def start(self) -> int:
        return self.word2idx[START]

    @property
    def end(self) -> int:
        return self.word2idx[END]

    @property
    def unk(self) -> int:
        return self.word2idx[UNK]

    def encode(self, tokens: Iterable[str]) -> List[int]:
        """``<start> tok... <end>`` id list (data_loader.py:74-81)."""
        return [self.start] + [self(t) for t in tokens] + [self.end]

    def decode(self, ids: Iterable[int], strip_specials: bool = True) -> List[str]:
        words = [self.idx2word[int(i)] for i in ids]
        if strip_specials:
            words = [w for w in words if w not in (START, END, PAD)]
        return words

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"words": [self.idx2word[i] for i in range(self.idx)]}, f)

    @classmethod
    def from_json(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            data = json.load(f)
        v = cls()
        for w in data["words"]:
            v.add_word(w)
        return v


class _RemapUnpickler(pickle.Unpickler):
    """Maps every pickled ``Vocabulary`` — this package's, the JAX package's
    (``icee_tpu.data.vocab``) or the reference's (``build_vocab``) — onto
    :class:`Vocabulary`, and refuses any other class from the JAX package, so
    loading never imports it."""

    def find_class(self, module: str, name: str):  # noqa: D102
        if name == "Vocabulary":
            return Vocabulary
        if module == "icee_tpu" or module.startswith("icee_tpu."):
            raise pickle.UnpicklingError(
                f"unexpected class {module}.{name} in a vocabulary pickle")
        return super().find_class(module, name)


def load_vocab(path: str) -> Vocabulary:
    """Load a vocabulary pickle written by either package or the reference."""
    with open(path, "rb") as f:
        obj = _RemapUnpickler(f).load()
    if isinstance(obj, Vocabulary):
        return obj
    # pickle of a foreign Vocabulary restored as a bare instance dict
    v = Vocabulary()
    v.word2idx = dict(obj.word2idx)
    v.idx2word = {int(k): w for k, w in obj.idx2word.items()}
    v.idx = int(obj.idx)
    return v


def build_vocab(path: str, threshold: int = 4) -> Vocabulary:
    """Build the vocabulary exactly like ``build_vocab.py:30-61``: text after
    the last tab, periods removed, lowercased, tokenized as one string, words
    with frequency >= threshold in corpus order after the four specials."""
    with open(path, "r") as f:
        lines = f.readlines()

    text = ""
    for line in lines:
        line = line.split("\t")[-1]
        line = line.replace(".", "")
        line = line.strip()
        text += line + " "
    text = text.strip().lower()

    counter = Counter(word_tokenize(text))
    vocab = Vocabulary()
    for s in SPECIALS:
        vocab.add_word(s)
    for w, c in counter.items():
        if c >= threshold:
            vocab.add_word(w)
    return vocab
