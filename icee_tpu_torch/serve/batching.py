"""Cross-request serving batching: one batched beam decode per window (port
of ``icee_tpu/serve/batching.py``).

:class:`BatchingEngine` wraps :class:`~icee_tpu_torch.serve.engine.
CaptionEngine` with the same ``caption(image_path, mode)`` contract.
Concurrent callers enqueue; a collector thread drains the queue for
``window_ms`` or until ``max_batch``, groups requests by mode, runs ONE
backbone pass per image, and decodes each loaded variant's beams for the
group with ONE launch of a whole-search kernel: K2 (``cell="factored"`` for
stylenet, ``cell="lstm"`` for nic) or K7 (``kind="factored"`` for
stylenet_att, ``kind="lstm"`` for nic_att, on the spatial features).  Groups are padded to the next power of
two with copies of the first feature, as in the JAX engine.  Captions equal
the serial engine's.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List

import torch

from icee_tpu_torch.core.config import MODES
from icee_tpu_torch.serve.config import MODEL_VARIANTS


class _Pending:
    __slots__ = ("image_path", "mode", "event", "result", "error")

    def __init__(self, image_path: str, mode: str):
        self.image_path = image_path
        self.mode = mode
        self.event = threading.Event()
        self.result = None
        self.error = None


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class BatchingEngine:
    """Same ``caption()`` contract as CaptionEngine, batched across threads."""

    def __init__(self, engine, window_ms: float = 4.0, max_batch: int = 8):
        self.engine = engine
        self.window = window_ms / 1e3
        self.max_batch = max_batch
        self.group_sizes: List[int] = []  # instrumentation (tests/metrics)
        self._q: "queue.SimpleQueue[_Pending]" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="caption-batcher")
        self._thread.start()

    def caption(self, image_path: str, mode: str) -> Dict[str, str]:
        if mode not in MODES:
            raise ValueError(f"invalid mode {mode}")
        item = _Pending(image_path, mode)
        self._q.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _loop(self):
        while True:
            batch = [self._q.get()]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            by_mode: Dict[str, List[_Pending]] = {}
            for item in batch:
                by_mode.setdefault(item.mode, []).append(item)
            for mode, items in by_mode.items():
                try:
                    self._run_group(mode, items)
                except Exception as e:  # noqa: BLE001 - report to callers
                    for item in items:
                        item.error = e
                        item.event.set()

    def _run_group(self, mode: str, items: List[_Pending]):
        self.group_sizes.append(len(items))
        eng = self.engine
        results = [{variant: "-" for variant in MODEL_VARIANTS} for _ in items]
        loaded = [v for v in MODEL_VARIANTS if mode in eng.models.get(v, {})]
        maps = [eng._features(item.image_path) for item in items] \
            if loaded else []
        n = len(items)
        n_pad = _next_pow2(n)
        for variant in loaded:
            # the head runs per image, as in the serial path: a GEMM library
            # may pick another summation order for another row count, and
            # the captions must not depend on the group's size
            feats = torch.cat([eng.features(p, s, mode, variant)
                               for p, s in maps])
            if n_pad != n:
                feats = torch.cat([feats] + [feats[:1]] * (n_pad - n))
            res = eng.decode(feats, mode, "mega", variant)
            for i, r in enumerate(results):
                r[variant] = eng._detok(res.tokens[i], res.length[i])
        for item, r in zip(items, results):
            item.result = r
            item.event.set()
