"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Asking for CUDA
where there is none raises: nothing falls back to the CPU quietly.

float32 means float32 on the card: :func:`resolve_device` turns TF32 off for
cuBLAS products and cuDNN convolutions whenever it resolves a CUDA device, so
every entry point (the serving engine and app, the training steps, the
SentiCap trainer and decoder) computes what the JAX package computes on its
CPU reference, and what ``chip_smoke.py`` checks and times.
"""

from __future__ import annotations

import torch


def set_float32_precision() -> None:
    """Full float32 for matmuls and convolutions: TF32 off in cuBLAS and
    cuDNN (PyTorch's default leaves cuDNN's convolutions in TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions")
        set_float32_precision()
    return dev


def resolve_indexed_device(device="cuda") -> torch.device:
    """:func:`resolve_device`, with a CUDA device's index made explicit (the
    current device), so that it compares equal to a tensor's ``.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
