"""Structured JSONL metrics (port of ``icee_tpu/utils/logging.py``).

The reference logs via ``print`` plus an append-only text file
(``train_multitask.py:216,254``); the trainers keep that text contract, and
this writer adds one JSON record per event (per-epoch losses, top-5 and
BLEU, LR decays, early stop) so that runs are machine-readable."""

from __future__ import annotations

import json
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics writer (one record per event)."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"t": time.time(), "event": event, **fields}
        with open(self.path, "a+") as f:
            f.write(json.dumps(rec) + "\n")
