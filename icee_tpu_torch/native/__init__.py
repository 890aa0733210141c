"""Native (C++) host data path with a transparent NumPy fallback (port of
``icee_tpu/native/__init__.py``).

``RaggedCaptions`` stores a corpus of encoded captions as one flat int32
stream plus prefix offsets (encode once, reuse every epoch — the reference
re-tokenizes text in DataLoader workers each epoch).  Batch assembly and the
token histogram dispatch to the threaded C++ library (``batcher.cpp``),
built with ``g++`` at first use into ``icee_tpu_torch/_build/``; where no
toolchain is available everything falls back to NumPy with identical
results (tested equal).  The port's loaders ask for NumPy
(``force_numpy=True``, ``data/pipeline.py``): the C++ path is the JAX
package's API, kept equal to it, and stays off the training path until a
trace shows batch assembly costing an epoch time.  :func:`build_library`
also builds the JPEG decoder of :mod:`icee_tpu_torch.native.imagedec`.
This is host code: nothing here runs on the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Sequence

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
# beside the CUDA kernels' libraries, outside any package directory, so that
# module scanners (pkgutil) never take a ctypes library for an extension
BUILD_DIR = os.path.join(os.path.dirname(NATIVE_DIR), "_build")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def build_library(name: str, signatures: Dict[str, tuple],
                  link: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """``native/{name}.cpp`` built once into ``_build/libicee_{name}.so``
    and loaded, each C function's ``(argtypes, restype)`` from
    ``signatures`` declared; None where the build or the load fails (no
    ``g++``, a missing header or library), and then on every later call
    too.  A build writes a temporary file and moves it in with
    ``os.replace``, so that concurrent processes and threads never load a
    half-written library."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(NATIVE_DIR, name + ".cpp")
        lib_path = os.path.join(BUILD_DIR, f"libicee_{name}.so")
        lib = None
        try:
            if not os.path.exists(lib_path) or (
                    os.path.getmtime(lib_path) < os.path.getmtime(src)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so",
                                           prefix=f"icee_{name}_",
                                           dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-pthread", src,
                         *link, "-o", tmp], check=True, capture_output=True)
                    os.replace(tmp, lib_path)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(lib_path)
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
        except (OSError, subprocess.CalledProcessError):
            lib = None
        _libs[name] = lib
        return lib


_I32, _I64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
BATCHER_SIGNATURES = {
    "make_padded_batch": ([_I32, _I64, _I64, ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_int32, _I32, _I32, ctypes.c_int32], None),
    "count_tokens": ([_I32, ctypes.c_int64, ctypes.c_int32, _I64,
                      ctypes.c_int32], None),
}


def _load() -> Optional[ctypes.CDLL]:
    return build_library("batcher", BATCHER_SIGNATURES)


def native_available() -> bool:
    """Whether the C++ batcher built and loaded here."""
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


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

    def batch(self, indices: np.ndarray, max_len: int, pad_id: int = 0,
              n_threads: int = 4, force_numpy: bool = False):
        """-> (captions (n, max_len) int32, lengths (n,) int32); captions
        longer than ``max_len`` are cut.  The C++ batcher where it built,
        unless ``force_numpy``."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        captions = np.empty((n, max_len), np.int32)
        lengths = np.empty((n,), np.int32)
        lib = None if force_numpy else _load()
        if lib is not None:
            lib.make_padded_batch(
                _ptr(self.data, ctypes.c_int32),
                _ptr(self.offsets, ctypes.c_int64),
                _ptr(indices, ctypes.c_int64),
                ctypes.c_int64(n), ctypes.c_int32(max_len),
                ctypes.c_int32(pad_id),
                _ptr(captions, ctypes.c_int32),
                _ptr(lengths, ctypes.c_int32), ctypes.c_int32(n_threads))
            return captions, lengths
        captions.fill(pad_id)
        for i, row in enumerate(indices):
            seq = self.data[self.offsets[row]:self.offsets[row + 1]][:max_len]
            captions[i, : len(seq)] = seq
            lengths[i] = len(seq)
        return captions, lengths

    def token_counts(self, vocab_size: int, n_threads: int = 4,
                     force_numpy: bool = False) -> np.ndarray:
        """(vocab_size,) int64 histogram of the ids in [0, vocab_size)."""
        lib = None if force_numpy else _load()
        if lib is not None:
            counts = np.empty((vocab_size,), np.int64)
            lib.count_tokens(
                _ptr(self.data, ctypes.c_int32),
                ctypes.c_int64(self.data.size), ctypes.c_int32(vocab_size),
                _ptr(counts, ctypes.c_int64), ctypes.c_int32(n_threads))
            return counts
        return np.bincount(
            self.data[(self.data >= 0) & (self.data < vocab_size)],
            minlength=vocab_size).astype(np.int64)
