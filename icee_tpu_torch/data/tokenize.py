"""Word tokenization with reference parity (copy of
``icee_tpu/data/tokenize.py``).

The reference tokenizes every caption with ``nltk.tokenize.word_tokenize``
(``stylenet/build_vocab.py:45``), which is the Punkt sentence splitter + the
regex-based ``NLTKWordTokenizer``.  The Punkt data model is unavailable
offline, but ``NLTKWordTokenizer`` is pure regex code shipped with nltk, so
``word_tokenize`` is reproduced as: a conservative sentence split on ``.!?``
followed by whitespace -> ``NLTKWordTokenizer`` per sentence.  For the
caption domain this is exactly equivalent (periods are stripped before
tokenizing and captions are single sentences).

A pure-Python fallback tokenizer is included for environments without nltk.
"""

from __future__ import annotations

import functools
import re
from typing import List


@functools.lru_cache(maxsize=None)
def _nltk_tokenizer():
    """nltk's regex tokenizer (it needs no downloaded data), imported at
    first use: importing nltk takes seconds (it imports scipy.stats), which
    every process that only unpickles a vocabulary would pay."""
    try:
        from nltk.tokenize.destructive import NLTKWordTokenizer
    except ImportError:  # pragma: no cover - exercised only without nltk
        return None
    return NLTKWordTokenizer()

_SENT_RE = re.compile(r"(?<=[.!?])\s+")

# Fallback rules approximating TreebankWordTokenizer for plain lowercase text.
_FALLBACK_RE = re.compile(r"[\w-]+|[^\w\s]")


def sent_split(text: str) -> List[str]:
    """Conservative sentence split standing in for Punkt."""
    parts = _SENT_RE.split(text.strip())
    return [p for p in parts if p]


def word_tokenize(text: str) -> List[str]:
    """Reference-parity ``nltk.tokenize.word_tokenize`` without Punkt data."""
    tokenizer = _nltk_tokenizer()
    if tokenizer is not None:
        return [tok for sent in sent_split(text)
                for tok in tokenizer.tokenize(sent)]
    return _FALLBACK_RE.findall(text)
