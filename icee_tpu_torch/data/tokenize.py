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

import re
from typing import List

try:  # nltk's regex tokenizer needs no downloaded data
    from nltk.tokenize.destructive import NLTKWordTokenizer

    _NLTK_TOKENIZER = NLTKWordTokenizer()
except Exception:  # pragma: no cover - exercised only without nltk
    _NLTK_TOKENIZER = None

_SENT_RE = re.compile(r"(?<=[.!?])\s+")

# Fallback rules approximating TreebankWordTokenizer for plain lowercase text.
_FALLBACK_RE = re.compile(r"[\w-]+|[^\w\s]")


def sent_split(text: str) -> List[str]:
    """Conservative sentence split standing in for Punkt."""
    parts = _SENT_RE.split(text.strip())
    return [p for p in parts if p]


def word_tokenize(text: str) -> List[str]:
    """Reference-parity ``nltk.tokenize.word_tokenize`` without Punkt data."""
    if _NLTK_TOKENIZER is not None:
        return [
            tok for sent in sent_split(text) for tok in _NLTK_TOKENIZER.tokenize(sent)
        ]
    return _FALLBACK_RE.findall(text)
