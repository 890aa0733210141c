"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU.  Asking for CUDA
where there is none raises: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev
