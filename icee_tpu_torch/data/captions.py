"""Caption-file parsing with reference parity (copy of
``icee_tpu/data/captions.py``).

File format (Indonesian Flickr8k splits): one line per caption,
``name.jpg#n<TAB>caption text``, split by the regex ``#\\d*``
(``stylenet/data_loader.py:26-32``).  Styled corpora for the StyleNet paper
regime are one caption per line with no image name
(``stylenet/data_loader.py:87-113``); seq2seq pairs every styled caption with
every factual caption of the same image (``seq2seq/data_loader.py:73-101``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Tuple

from icee_tpu_torch.data.tokenize import word_tokenize
from icee_tpu_torch.data.vocab import Vocabulary

_SPLIT_RE = re.compile(r"#\d*")


@dataclasses.dataclass
class CaptionExample:
    """One (image, caption) pair plus all reference captions of that image."""

    image: str
    caption_ids: List[int]
    all_caption_ids: List[List[int]]


def parse_caption_file(path: str) -> List[Tuple[str, str]]:
    """-> list of (image_name, caption_text), order-preserving."""
    with open(path, "r") as f:
        lines = f.readlines()
    out = []
    for line in lines:
        parts = [x.strip() for x in _SPLIT_RE.split(line)]
        out.append((parts[0], parts[1]))
    return out


def image_caption_map(path: str) -> Dict[str, List[str]]:
    """image name -> all its captions (data_loader.py:34-49)."""
    out: Dict[str, List[str]] = {}
    for name, cap in parse_caption_file(path):
        out.setdefault(name, []).append(cap)
    return out


def encode_caption(text: str, vocab: Vocabulary) -> List[int]:
    """lowercase -> tokenize -> ``<start> ids <end>`` (data_loader.py:65-66,74-81)."""
    return vocab.encode(word_tokenize(str(text).lower()))


def load_caption_dataset(path: str, vocab: Vocabulary) -> List[CaptionExample]:
    """Image+caption dataset with per-image reference lists for BLEU."""
    pairs = parse_caption_file(path)
    cap_map = image_caption_map(path)
    encoded_map = {
        name: [encode_caption(c, vocab) for c in caps] for name, caps in cap_map.items()
    }
    return [
        CaptionExample(
            image=name,
            caption_ids=encode_caption(cap, vocab),
            all_caption_ids=encoded_map[name],
        )
        for name, cap in pairs
    ]


def load_styled_caption_dataset(path: str, vocab: Vocabulary) -> List[List[int]]:
    """Text-only styled corpus: one caption per line (data_loader.py:87-113)."""
    with open(path, "r") as f:
        lines = [x.strip() for x in f.readlines()]
    return [encode_caption(line, vocab) for line in lines]


@dataclasses.dataclass
class PairedStyleExample:
    """seq2seq item: image + factual source + styled target
    (seq2seq/data_loader.py:103-132)."""

    image: str
    source_ids: List[int]     # factual caption
    target_ids: List[int]     # styled caption


def load_paired_style_dataset(
    factual_path: str, styled_path: str, vocab: Vocabulary
) -> List[PairedStyleExample]:
    """Pair each styled caption with every factual caption of its image."""
    factual_map = image_caption_map(factual_path)
    out: List[PairedStyleExample] = []
    for name, styled_cap in parse_caption_file(styled_path):
        styled_ids = encode_caption(styled_cap, vocab)
        for factual_cap in factual_map[name]:
            out.append(
                PairedStyleExample(
                    image=name,
                    source_ids=encode_caption(factual_cap, vocab),
                    target_ids=styled_ids,
                )
            )
    return out
