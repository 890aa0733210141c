"""Native JPEG batch feeder: C++ libjpeg decode + threaded bilinear resize
(port of ``icee_tpu/native/imagedec.py``).

The reference decodes images with PIL inside Python DataLoader workers
(``stylenet/data_loader.py:57-66``); here one ctypes call decodes and
resizes a whole batch in C++ threads with no GIL.  It falls back to the PIL
path when the toolchain or libjpeg is unavailable.

Parity: JPEG IDCT rounding may differ by ±1 LSB between libjpeg builds and
the resize is classic bilinear (PIL applies an antialias filter when
downscaling), so this is an opt-in throughput feeder
(``precompute_features --native_decode``); the serving and eval paths keep
:func:`icee_tpu_torch.data.transforms.host_decode_resize` (PIL).
``tests/test_torch_native.py`` bounds the deviation.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from icee_tpu_torch.native import build_library

SIGNATURES = {
    "decode_resize_batch": (
        [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
         ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
         ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32], ctypes.c_int32),
}


def _load() -> Optional[ctypes.CDLL]:
    return build_library("imagedec", SIGNATURES, link=("-ljpeg",))


def native_available() -> bool:
    """Whether the C++ decoder built (``g++`` and ``jpeglib.h``) and
    loaded here."""
    return _load() is not None


def decode_resize_batch(jpegs: Sequence[bytes], size: int,
                        n_threads: int = 4,
                        force_pil: bool = False) -> np.ndarray:
    """Decode a batch of JPEG byte strings -> (n, size, size, 3) uint8.

    Failed decodes come back as black images (matching the C side);
    ``force_pil`` takes the fallback.
    """
    n = len(jpegs)
    out = np.empty((n, size, size, 3), np.uint8)
    lib = None if force_pil else _load()
    if lib is not None:
        bufs = (ctypes.c_void_p * n)()
        sizes = np.empty((n,), np.int64)
        # keep strong references so the buffers outlive the call
        holders = [np.frombuffer(j, np.uint8) for j in jpegs]
        for i, h in enumerate(holders):
            bufs[i] = h.ctypes.data_as(ctypes.c_void_p).value
            sizes[i] = h.size
        lib.decode_resize_batch(
            bufs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n), ctypes.c_int32(size), ctypes.c_int32(size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(n_threads))
        return out
    import io

    from PIL import Image

    from icee_tpu_torch.data.transforms import host_decode_resize

    for i, j in enumerate(jpegs):
        try:
            out[i] = host_decode_resize(Image.open(io.BytesIO(j)), size)
        except Exception:  # an undecodable image is black, as on the C side
            out[i] = 0
    return out


def decode_resize_paths(paths: Sequence[str], size: int,
                        n_threads: int = 4) -> np.ndarray:
    """File-path convenience wrapper over :func:`decode_resize_batch`."""
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    return decode_resize_batch(bufs, size, n_threads=n_threads)
