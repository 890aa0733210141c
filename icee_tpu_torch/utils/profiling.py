"""Tracing / profiling (port of ``icee_tpu/utils/profiling.py``).

The reference has none — only wall-clock ``AverageMeter`` batch timing
(``utils.py:93-111``; SURVEY.md §5 flags this as a gap to fill).  Here:

- :func:`trace` — context manager around ``torch.profiler`` (CPU activity,
  and CUDA activity where CUDA is available) that writes a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``) into
  ``log_dir``,
- :class:`StepTimer` — cheap steady-state step timing with warmup discard
  and percentile summary, for regression tracking in logs.

One difference from the JAX package: JAX's ``StepTimer`` reads the clock
when the step's Python returns, which for jitted code is after its
dispatch; here, when CUDA is initialized, the step's time is read after
``torch.cuda.synchronize()``, so it includes the card's work.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """``with trace("/tmp/trace"):`` profiles everything inside into
    ``log_dir/trace.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Per-step wall-clock stats (discarding warmup steps)."""

    def __init__(self, warmup: int = 2) -> None:
        self.warmup = warmup
        self._times: list = []
        self._seen = 0
        self._t0: Optional[float] = None

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    def __enter__(self) -> "StepTimer":
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync()
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        arr = np.asarray(self._times)
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1000),
            "p50_ms": float(np.percentile(arr, 50) * 1000),
            "p95_ms": float(np.percentile(arr, 95) * 1000),
        }
