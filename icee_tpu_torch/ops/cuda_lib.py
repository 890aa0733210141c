"""Build and load the hand-written CUDA kernels under ``icee_tpu_torch/csrc``.

Each ``.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) at first use into
``icee_tpu_torch/_build/`` and loaded with ``ctypes``.  The library's file
name carries a hash of its sources and flags, so an edited source rebuilds
and an unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per
source, all at once.  Nothing here runs at import time: the CPU tests import
every module on hosts with no CUDA toolkit.

Wrapper helpers :func:`check_tensor` and :func:`check_rc` hold the rules every
kernel wrapper follows: inputs are validated before a pointer leaves Python,
and a non-zero CUDA error from the C side raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("decode_step", "beam", "lstm_scan", "nic_scan", "chunked_ce",
           "att_decode_step", "att_beam", "att_scan", "senticap_scan",
           "senticap_beam", "senticap_switched_beam")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                       "with the CUDA toolkit")


def _target(name: str) -> Tuple[str, str]:
    """(library path, source path) for one kernel source."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")) and (fn == name + ".cu"
                                             or fn.endswith(".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                digest.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:12]}.so"), src


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` process per source, all
    started together.  Returns ``{name: library path}``; the compiler's
    resource report (``-Xptxas -v``) is kept beside each library as
    ``.log``.  Raises with the compiler output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        lib, src = _target(name)
        paths[name] = lib
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        with open(lib + ".log", "wb") as f:
            f.write(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(rc {proc.returncode}):\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str, signatures: Dict[str, Tuple[list, type]]
            ) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed, with each
    C function's ``(argtypes, restype)`` from ``signatures`` declared."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build_all([name])[name])
            signatures = dict(signatures,
                              icee_error_string=([ctypes.c_int],
                                                 ctypes.c_char_p))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.icee_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def check_tensor(name: str, t, shape, dtype, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this shape and dtype on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


_checked: Dict[tuple, tuple] = {}
_CHECKED_MAX = 32


def _state(t) -> tuple:
    if isinstance(t, torch.Tensor):
        return id(t), None if t.is_inference() else t._version
    return id(t), None


def checked_weights(trees: Tuple[dict, ...], extra: tuple, check):
    """``check()``: the validation of the weight dicts ``trees`` and what
    it derives from them (widths, the weight arguments' addresses), kept
    while every value in ``trees`` is the same object at the same version,
    so that a decode loop validates its weights once and not at every
    step.  ``extra`` (the kind, the input widths, the device) is part of
    the key.  A failing ``check`` raises and keeps nothing."""
    key = tuple(map(id, trees)) + extra
    state = tuple(_state(t) for tree in trees for t in tree.values())
    hit = _checked.get(key)
    if hit is not None and hit[0] == state:
        return hit[2]
    result = check()
    if len(_checked) >= _CHECKED_MAX:
        _checked.clear()
    _checked[key] = (state, trees, result)  # trees held: their ids stay theirs
    return result


def ptr(t: torch.Tensor) -> int:
    """A tensor's address for a ``ctypes.c_void_p`` argument (declared in
    the library's argtypes, which take a plain int)."""
    return t.data_ptr()


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
