"""Parameter initializers with the reference's torch init semantics, drawn
from a ``torch.Generator`` (port of ``icee_tpu/core/initializers.py``).

Weights are stored ``(in, out)`` as in the JAX package, so the forward pass is
``x @ W + b``.  Every initializer draws on the generator's device (the CPU by
default, so a seed gives the same numbers on every host) and then moves the
tensor to ``device``.  The draws differ from ``jax.random``'s for the same seed;
tests move JAX weights across with :mod:`icee_tpu_torch.bridge` instead.
"""

from __future__ import annotations

import math

import torch


def _uniform(generator: torch.Generator, shape, bound: float, dtype, device):
    out = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    out.uniform_(-bound, bound, generator=generator)
    return out.to(device)


def xavier_uniform(generator: torch.Generator, shape, dtype=torch.float32,
                   device="cpu") -> torch.Tensor:
    """torch ``nn.init.xavier_uniform_`` (gain=1) with fans from the last two
    dims ``(in, out)``; leading dims are independent slices."""
    if len(shape) < 2:
        raise ValueError("xavier_uniform requires >=2-D shape")
    fan_in, fan_out = shape[-2], shape[-1]
    return _uniform(generator, shape, math.sqrt(6.0 / (fan_in + fan_out)),
                    dtype, device)


def uniform(generator: torch.Generator, shape, bound: float,
            dtype=torch.float32, device="cpu") -> torch.Tensor:
    """U(-bound, bound) — embedding/output-head init (``model.py:111-113``)."""
    return _uniform(generator, shape, bound, dtype, device)


def torch_linear_default(generator: torch.Generator, shape, fan_in: int,
                         dtype=torch.float32, device="cpu") -> torch.Tensor:
    """torch ``nn.Linear`` default: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(generator, shape, 1.0 / math.sqrt(fan_in), dtype, device)


def zeros(shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)
