"""Device-resident caption splits: whole epochs gathered on the card (port
of ``icee_tpu/data/device.py``).

The host loader (:mod:`icee_tpu_torch.data.pipeline`) builds every batch
on the host and copies it to the card, and the trainer reads every step's
loss.  :class:`DeviceCaptionData` instead holds the whole split on the
device once: the features of each UNIQUE image (Flickr-style splits carry 5
captions an image, so one copy instead of five), the (N, T) captions and
the (N,) lengths.  An epoch then moves only its (nb, B) batch indices to
the card, and each batch is gathered there with ``torch.index_select`` on
the pinned tensors, which reads them in place.

:meth:`DeviceCaptionData.epoch_indices` composes an epoch exactly as the
port's ``BatchLoader._index_batches`` does (the same seeded
``np.random.default_rng`` shuffle, the same trailing partial batch), so a
device epoch and a host-loader epoch visit the same batches; with the
trainer's randomness drawn in the same order they give the same
parameters.  On a mesh (``icee_tpu_torch/parallel``) every rank holds the
whole split, as JAX replicates it, gathers the same global batches and
computes on its rows of them.

A split whose features exceed the card's budget (:func:`pin_plan`) becomes
a :class:`StreamedCaptionData`: captions and lengths on the card, features
on the host, an epoch cut into chunks of batch rows.  While chunk c trains,
a worker thread gathers chunk c+1's unique features into a page-locked
staging buffer and copies them to one of two device buffers with
``non_blocking=True`` on a side stream, ordered by CUDA events.  The two
buffers take half the budget each.

Features may be stored as bfloat16 (``feature_dtype=torch.bfloat16``);
every gather casts them back to float32 before the step, so the only
difference from float32 storage is the one-time rounding.

Not ported: JAX's ``gather_rows`` and the ``per_batch`` tier, which work
around XLA:TPU copying a gather's operand and a loop's state (a PyTorch
loop copies neither), and the stale ``fits_device``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from icee_tpu_torch.core.device import resolve_indexed_device
from icee_tpu_torch.data.pipeline import pad_captions


@dataclasses.dataclass
class DeviceCaptionData:
    """A caption split held on a device, and the host-side epoch index
    maker.  ``images``/``captions``/``lengths`` are tensors of the FULL
    split on one device; shuffling happens on the host over indices."""

    images: Optional[torch.Tensor]   # (U, ...) float32/bfloat16 features of
    #                                  the UNIQUE images; None: text only
    captions: torch.Tensor           # (N, T) int64
    lengths: torch.Tensor            # (N,) int64
    num_examples: int
    batch_size: int
    shuffle: bool = True
    seed: int = 0
    # host-side per-example reference caption lists (every reference of the
    # image), for the validation BLEU; never on the device
    references: Optional[List[List[List[int]]]] = None
    # host-side (N,) example -> unique-image row map (None for text-only
    # corpora), translated a batch at a time by image_rows
    image_index: Optional[np.ndarray] = None
    _rng: np.random.Generator = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def __len__(self) -> int:
        return -(-self.num_examples // self.batch_size)

    @property
    def device(self) -> torch.device:
        return self.captions.device

    def epoch_indices(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> ((nb, B) int32 example indices, (nb, B) bool sample mask).

        The composition of ``BatchLoader._index_batches`` (same seeded
        generator, same trailing partial batch); padding rows index example
        0 with ``valid=False``, and the trainer zeroes them."""
        idx = np.arange(self.num_examples)
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        out = np.zeros((nb, self.batch_size), np.int32)
        valid = np.zeros((nb, self.batch_size), bool)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            out[b, : len(chunk)] = chunk
            valid[b, : len(chunk)] = True
        return out, valid

    def image_rows(self, idx: np.ndarray) -> np.ndarray:
        """Example-index rows (``epoch_indices``) -> unique-image rows of
        ``images``."""
        if self.image_index is None:
            return np.asarray(idx, np.int32)
        return self.image_index[idx].astype(np.int32)

    def sample_feature(self, unique_row: int) -> torch.Tensor:
        """One image's features (1, ...) as float32, on the device."""
        return self.images[unique_row:unique_row + 1].float()


def gather_batch(images, captions, lengths, bidx, b_img, bvalid):
    """One batch gathered on the device -> (features float32 or None,
    captions, lengths).  Padded rows (``bvalid`` False) are zeroed as the
    host loader pads them: features and captions times the mask, lengths
    0, so BatchNorm's batch statistics see what a host batch gives."""
    caps = captions.index_select(0, bidx) * bvalid[:, None]
    lens = torch.where(bvalid, lengths.index_select(0, bidx), 0)
    if images is None:
        return None, caps, lens
    feats = images.index_select(0, b_img).float()
    feats = feats * bvalid.reshape((-1,) + (1,) * (feats.dim() - 1)).to(
        feats.dtype)
    return feats, caps, lens


@dataclasses.dataclass
class StreamedCaptionData(DeviceCaptionData):
    """A split whose features exceed the device budget (:func:`pin_plan`):
    captions and lengths on the device, features on the host, streamed a
    chunk of ``rows_per_chunk`` batch rows at a time.

    Each chunk's unique features are compacted into the first rows of a
    ``capacity``-row buffer (:meth:`chunk_features`) and gathered through a
    remap, so a chunk's batches equal the pinned split's bit for bit.  The
    epoch composition is :class:`DeviceCaptionData`'s."""

    host_features: Optional[torch.Tensor] = None   # (U, ...) on the host
    capacity: int = 0                              # feature rows a buffer
    _stream_state: Optional[dict] = dataclasses.field(
        default=None, init=False, repr=False)

    def __post_init__(self):
        super().__post_init__()
        if self.images is not None:
            raise ValueError("streamed data keeps its features on the host")
        self.capacity = max(self.capacity, self.batch_size)

    @property
    def rows_per_chunk(self) -> int:
        """Batch rows a chunk: the no-dedup bound, so any chunk's unique
        features fit ``capacity``."""
        return max(self.capacity // self.batch_size, 1)

    def chunk_features(self, img_rows: np.ndarray
                       ) -> Tuple[torch.Tensor, np.ndarray]:
        """One chunk's plan: ``img_rows`` (rows, B) unique-image rows ->
        (features (capacity, ...) on the host, the chunk's unique features
        in rows [0, n_unique) and row 0 repeated after them; remap (rows,
        B) int32 into it)."""
        take, remap = self._plan(img_rows)
        return self.host_features.index_select(0, take), remap

    def _plan(self, img_rows: np.ndarray) -> Tuple[torch.Tensor, np.ndarray]:
        flat = np.asarray(img_rows).ravel()
        uniq, inv = np.unique(flat, return_inverse=True)
        if len(uniq) > self.capacity:
            raise ValueError(
                f"chunk needs {len(uniq)} unique features > capacity "
                f"{self.capacity} (rows_per_chunk is miscomputed)")
        take = np.zeros(self.capacity, np.int64)
        take[: len(uniq)] = uniq
        remap = inv.astype(np.int32).reshape(np.asarray(img_rows).shape)
        return torch.from_numpy(take), remap

    def sample_feature(self, unique_row: int) -> torch.Tensor:
        return self.host_features[unique_row:unique_row + 1].to(
            self.device).float()

    def stream(self, img_rows: np.ndarray, bounds: Sequence[Tuple[int, int]]
               ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """For each chunk ``[r0, r1)`` of ``bounds`` in turn, yield (its
        features buffer on the device, its (r1 - r0, B) int64 remap on the
        device).  On CUDA a worker thread gathers chunk c+1's features into
        page-locked staging and copies them on a side stream while the
        caller's work on chunk c runs: resume the generator only after that
        work is enqueued, since chunk c's buffer is refilled once the
        current stream passes that point."""
        if self.device.type != "cuda":
            for r0, r1 in bounds:
                feats, remap = self.chunk_features(img_rows[r0:r1])
                yield feats.to(self.device), torch.from_numpy(remap).long()
            return
        st = self._cuda_buffers()
        main = torch.cuda.current_stream(self.device)

        def prefetch(c: int) -> None:
            r0, r1 = bounds[c]
            slot = c % 2
            take, remap = self._plan(img_rows[r0:r1])
            st["copied"][slot].synchronize()    # its staging copy is done
            torch.index_select(self.host_features, 0, take,
                               out=st["stage"][slot])
            st["stage_remap"][slot][: r1 - r0].copy_(torch.from_numpy(remap))
            # the buffer's last chunk (c - 2) has finished on the device
            st["side"].wait_event(st["freed"][slot])
            with torch.cuda.stream(st["side"]):
                st["buf"][slot].copy_(st["stage"][slot], non_blocking=True)
                st["remap"][slot][: r1 - r0].copy_(
                    st["stage_remap"][slot][: r1 - r0], non_blocking=True)
                st["copied"][slot].record(st["side"])

        pending = st["worker"].submit(prefetch, 0) if bounds else None
        try:
            for c, (r0, r1) in enumerate(bounds):
                slot = c % 2
                pending.result()                 # chunk c's copy is issued
                pending = (st["worker"].submit(prefetch, c + 1)
                           if c + 1 < len(bounds) else None)
                main.wait_event(st["copied"][slot])
                try:
                    yield st["buf"][slot], st["remap"][slot][: r1 - r0]
                finally:
                    st["freed"][slot].record(main)
        finally:
            if pending is not None:
                pending.result()

    def _cuda_buffers(self) -> dict:
        """The two device buffers, their page-locked staging twins, the
        remap buffers, the side stream, the events and the gathering
        thread (made once)."""
        if self._stream_state is None:
            shape = (self.capacity,) + tuple(self.host_features.shape[1:])
            dtype = self.host_features.dtype
            rshape = (self.rows_per_chunk, self.batch_size)
            dev = self.device
            self._stream_state = {
                "buf": [torch.empty(shape, dtype=dtype, device=dev)
                        for _ in range(2)],
                "stage": [torch.empty(shape, dtype=dtype, pin_memory=True)
                          for _ in range(2)],
                "remap": [torch.empty(rshape, dtype=torch.int64, device=dev)
                          for _ in range(2)],
                "stage_remap": [torch.empty(rshape, dtype=torch.int64,
                                            pin_memory=True)
                                for _ in range(2)],
                "side": torch.cuda.Stream(dev),
                "copied": [torch.cuda.Event() for _ in range(2)],
                "freed": [torch.cuda.Event() for _ in range(2)],
                "worker": concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="icee-stream"),
            }
        return self._stream_state


def _captions_on(caption_ids, max_len: int, device):
    captions, lengths = pad_captions(caption_ids, max_len)
    return (torch.from_numpy(captions).long().to(device),
            torch.from_numpy(lengths).long().to(device))


def _pack_unique(examples, image_provider) -> Tuple[np.ndarray, np.ndarray]:
    """Features per UNIQUE image + the (N,) example -> unique-row map."""
    uniq, order = {}, []
    for e in examples:
        if e.image not in uniq:
            uniq[e.image] = len(order)
            order.append(e.image)
    image_index = np.asarray([uniq[e.image] for e in examples], np.int32)
    images = np.stack([image_provider(n) for n in order]).astype(np.float32)
    return images, image_index


def _stored(images: np.ndarray, feature_dtype) -> torch.Tensor:
    t = torch.from_numpy(images)
    return t if feature_dtype is None else t.to(feature_dtype)


def from_examples(
    examples: List,
    batch_size: int,
    max_len: int,
    image_provider: Callable[[str], np.ndarray],
    shuffle: bool = True,
    seed: int = 0,
    feature_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> DeviceCaptionData:
    """Pack ``CaptionExample``s and their features (the host loader's
    ``image_provider``) onto ``device`` (CUDA unless the caller asks for
    the CPU).  ``feature_dtype`` (e.g. ``torch.bfloat16``) stores the
    features narrower; each gathered batch is cast back to float32."""
    device = resolve_indexed_device(device)
    captions, lengths = _captions_on([e.caption_ids for e in examples],
                                     max_len, device)
    images, image_index = _pack_unique(examples, image_provider)
    return DeviceCaptionData(
        images=_stored(images, feature_dtype).to(device),
        captions=captions, lengths=lengths,
        num_examples=len(examples), batch_size=batch_size, shuffle=shuffle,
        seed=seed, references=[e.all_caption_ids for e in examples],
        image_index=image_index)


def from_examples_streamed(
    examples: List,
    batch_size: int,
    max_len: int,
    image_provider: Callable[[str], np.ndarray],
    shuffle: bool = True,
    seed: int = 0,
    budget_bytes: int = 4 << 30,
    feature_dtype: Optional[torch.dtype] = None,
    device="cuda",
) -> StreamedCaptionData:
    """Pack a split over the budget for streamed epochs: captions and
    lengths on ``device``, features on the host, chunk buffers of HALF the
    budget each (the stream double-buffers: chunk c+1 copies while chunk c
    trains)."""
    device = resolve_indexed_device(device)
    captions, lengths = _captions_on([e.caption_ids for e in examples],
                                     max_len, device)
    images, image_index = _pack_unique(examples, image_provider)
    host = _stored(images, feature_dtype)
    per = host[0].numel() * host.element_size()
    capacity = max(int((budget_bytes // 2) // per), batch_size)
    # no chunk needs more unique rows than the split has
    capacity = min(capacity, host.shape[0])
    return StreamedCaptionData(
        images=None, captions=captions, lengths=lengths,
        num_examples=len(examples), batch_size=batch_size, shuffle=shuffle,
        seed=seed, references=[e.all_caption_ids for e in examples],
        image_index=image_index, host_features=host, capacity=capacity)


def from_styled(
    caption_ids: List[List[int]],
    batch_size: int,
    max_len: int,
    shuffle: bool = True,
    seed: int = 0,
    device="cuda",
) -> DeviceCaptionData:
    """Pack a text-only styled corpus (the paper regime's emotion passes,
    ``stylenet/train.py:356-387``): captions and lengths on ``device``, no
    features."""
    device = resolve_indexed_device(device)
    captions, lengths = _captions_on(caption_ids, max_len, device)
    return DeviceCaptionData(
        images=None, captions=captions, lengths=lengths,
        num_examples=len(caption_ids), batch_size=batch_size,
        shuffle=shuffle, seed=seed)


def pin_plan(
    num_examples: int,
    feature_shape: Tuple[int, ...],
    budget_bytes: int = 4 << 30,
    bytes_per_feature: int = 4,
) -> str:
    """``"pin"`` when the features of ``num_examples`` UNIQUE images fit
    ``budget_bytes`` of device memory, else ``"stream"``.
    ``bytes_per_feature`` follows the storage dtype (2 for bfloat16).
    (JAX's plan wants twice the bytes to pin, because ``lax.scan`` copies
    its loop state; a PyTorch loop copies nothing.)"""
    per = int(np.prod(feature_shape)) * bytes_per_feature
    return "pin" if num_examples * per <= budget_bytes else "stream"
