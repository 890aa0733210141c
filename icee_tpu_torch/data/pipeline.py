"""Host input pipeline: fixed-shape masked batches with prefetch (port of
``icee_tpu/data/pipeline.py``).

Instead of the reference's length-sorted packed batches
(``stylenet/data_loader.py:116-197``), every batch is padded to a fixed
``(batch_size, max_len)`` shape with explicit ``lengths`` and a
``sample_mask`` for the padded rows of the last batch.  The losses and
metrics are mask-weighted so that they equal the packed normalization.

A background thread prefetches batches into a bounded queue; an exception
in it is raised in the consumer.  Shuffling uses a seeded
``np.random.default_rng(seed)``, so this loader and the JAX package's
compose the same batches in the same epochs.  Batches are NumPy; the
trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from icee_tpu_torch.native import RaggedCaptions


@dataclasses.dataclass
class CaptionBatch:
    """One padded batch. ``references`` are the ragged BLEU references."""

    images: Optional[np.ndarray]      # (B, ...) images or features
    captions: np.ndarray              # (B, L) int32, 0-padded
    lengths: np.ndarray               # (B,) int32 — includes <start>/<end>
    sample_mask: np.ndarray           # (B,) bool — False for batch padding
    references: Optional[List[List[List[int]]]] = None

    @property
    def batch_size(self) -> int:
        return self.captions.shape[0]


def pad_captions(
    caption_ids: Sequence[Sequence[int]], max_len: int, pad_id: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Pad a list of id lists to ``(N, max_len)``, cutting longer ones."""
    n = len(caption_ids)
    out = np.full((n, max_len), pad_id, dtype=np.int32)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, ids in enumerate(caption_ids):
        L = min(len(ids), max_len)
        out[i, :L] = np.asarray(ids[:L], dtype=np.int32)
        lengths[i] = L
    return out, lengths


def _pad_rows(x: np.ndarray, batch_size: int, pad_id=0) -> np.ndarray:
    """Append ``pad_id`` rows up to ``batch_size``."""
    n = x.shape[0]
    if n >= batch_size:
        return x
    return np.concatenate(
        [x, np.full((batch_size - n,) + x.shape[1:], pad_id, x.dtype)])


def make_batch(
    caption_ids: Sequence[Sequence[int]],
    max_len: int,
    batch_size: int,
    images: Optional[np.ndarray] = None,
    references: Optional[List[List[List[int]]]] = None,
    pad_id: int = 0,
) -> CaptionBatch:
    """Build one fixed-size batch, padding the trailing partial batch.

    Padded samples carry ``lengths=0`` and ``sample_mask=False`` so they
    contribute nothing to the masked loss.
    """
    n = len(caption_ids)
    if n > batch_size:
        raise ValueError(f"{n} examples > batch_size {batch_size}")
    captions, lengths = pad_captions(caption_ids, max_len, pad_id)
    return CaptionBatch(
        images=None if images is None else _pad_rows(images, batch_size),
        captions=_pad_rows(captions, batch_size, pad_id),
        lengths=_pad_rows(lengths, batch_size),
        sample_mask=np.arange(batch_size) < n,
        references=references,
    )


class BatchLoader:
    """Epoch iterator over an example list with shuffle + threaded prefetch.

    ``example_fn(indices) -> CaptionBatch`` materializes a batch from dataset
    indices.  Each epoch draws one permutation from the seeded generator.
    """

    def __init__(
        self,
        num_examples: int,
        batch_size: int,
        example_fn: Callable[[np.ndarray], CaptionBatch],
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        prefetch: int = 2,
    ) -> None:
        self.num_examples = num_examples
        self.batch_size = batch_size
        self.example_fn = example_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_examples // self.batch_size
        return -(-self.num_examples // self.batch_size)

    def _index_batches(self) -> List[np.ndarray]:
        idx = np.arange(self.num_examples)
        if self.shuffle:
            self._rng.shuffle(idx)
        batches = [
            idx[i : i + self.batch_size]
            for i in range(0, self.num_examples, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[CaptionBatch]:
        self._epoch += 1
        batches = self._index_batches()
        if self.prefetch <= 0:
            for b in batches:
                yield self.example_fn(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer() -> None:
            try:
                for b in batches:
                    q.put(self.example_fn(b))
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()


def caption_dataset_loader(
    examples,
    batch_size: int,
    max_len: int,
    image_provider: Optional[Callable[[str], np.ndarray]] = None,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
) -> BatchLoader:
    """Loader over :class:`icee_tpu_torch.data.captions.CaptionExample`
    lists; ``image_provider(name)`` gives each example's image or cached
    features.  Captions are encoded once into :class:`RaggedCaptions`."""
    rag = RaggedCaptions([e.caption_ids for e in examples])

    def example_fn(indices: np.ndarray) -> CaptionBatch:
        exs = [examples[i] for i in indices]
        images = None
        if image_provider is not None:
            images = _pad_rows(np.stack([image_provider(e.image)
                                         for e in exs]), batch_size)
        captions, lengths = rag.batch(indices, max_len=max_len)
        return CaptionBatch(
            images=images,
            captions=_pad_rows(captions, batch_size),
            lengths=_pad_rows(lengths, batch_size),
            sample_mask=np.arange(batch_size) < len(indices),
            references=[e.all_caption_ids for e in exs],
        )

    return BatchLoader(
        num_examples=len(examples),
        batch_size=batch_size,
        example_fn=example_fn,
        shuffle=shuffle,
        seed=seed,
        prefetch=prefetch,
    )


def styled_caption_loader(
    caption_ids,
    batch_size: int,
    max_len: int,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
) -> BatchLoader:
    """Loader over text-only styled corpora (the reference's
    ``get_style_loader``, ``data_loader.py:183-197``): batches carry captions
    + lengths only, no images."""
    rag = RaggedCaptions(caption_ids)

    def example_fn(indices: np.ndarray) -> CaptionBatch:
        captions, lengths = rag.batch(indices, max_len=max_len)
        return CaptionBatch(
            images=None,
            captions=_pad_rows(captions, batch_size),
            lengths=_pad_rows(lengths, batch_size),
            sample_mask=np.arange(batch_size) < len(indices),
        )

    return BatchLoader(
        num_examples=len(caption_ids),
        batch_size=batch_size,
        example_fn=example_fn,
        shuffle=shuffle,
        seed=seed,
        prefetch=prefetch,
    )
