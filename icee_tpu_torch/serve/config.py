"""Serving configuration: .env-driven checkpoint registry (copy of
``icee_tpu/serve/config.py``).

Parity target: ``app/backend/config.py:5-38`` (dotenv -> DEBUG / hosts /
IMAGE_FOLDER / VOCAB_PATH + 16 checkpoint paths, 4 model variants x 4 modes).
A minimal ``.env`` parser (KEY=VALUE lines, ``#`` comments, optional quotes)
stands in for ``python-dotenv``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from icee_tpu_torch.core.config import MODES

MODEL_VARIANTS = ("nic", "nic_att", "stylenet", "stylenet_att")


def load_dotenv(path: str = ".env") -> None:
    """Tiny KEY=VALUE loader (does not override existing env vars)."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip("'\"")
            os.environ.setdefault(key, value)


_ENV_KEYS = {
    "nic": "CHECKPOINT_PATH_NIC",
    "nic_att": "CHECKPOINT_PATH_NIC_ATT",
    "stylenet": "CHECKPOINT_PATH_STYLENET",
    "stylenet_att": "CHECKPOINT_PATH_STYLENET_ATT",
}
_MODE_SUFFIX = {"factual": "FAC", "happy": "HAP", "sad": "SAD", "angry": "ANG"}


@dataclasses.dataclass
class ServeConfig:
    debug: bool = False
    backend_host: str = "0.0.0.0"
    backend_port: int = 5000
    image_folder: str = "uploads/"
    vocab_path: Optional[str] = None
    resnet_weights: Optional[str] = None
    backbone_dtype: str = "float32"
    # >0: group concurrent /generate requests for this many ms and decode
    # them with ONE batched beam call (serve/batching.py); 0 = per-request
    batch_window_ms: float = 0.0
    # variant -> mode -> checkpoint path (may be None: variant disabled)
    checkpoint_paths: Dict[str, Dict[str, Optional[str]]] = None

    def __post_init__(self):
        if self.checkpoint_paths is None:
            self.checkpoint_paths = {
                v: {m: None for m in MODES} for v in MODEL_VARIANTS
            }


def load_config(env_path: str = ".env") -> ServeConfig:
    load_dotenv(env_path)
    ckpts = {
        v: {m: os.getenv(f"{_ENV_KEYS[v]}_{_MODE_SUFFIX[m]}") for m in MODES}
        for v in MODEL_VARIANTS
    }
    return ServeConfig(
        debug=os.getenv("DEBUG") == "true",
        backend_host=os.getenv("BACKEND_HOST") or "0.0.0.0",
        backend_port=int(os.getenv("BACKEND_HOST_PORT") or 5000),
        image_folder=os.getenv("IMAGE_FOLDER") or "uploads/",
        vocab_path=os.getenv("VOCAB_PATH"),
        resnet_weights=os.getenv("RESNET_WEIGHTS"),
        backbone_dtype=os.getenv("BACKBONE_DTYPE") or "float32",
        batch_window_ms=float(os.getenv("BATCH_WINDOW_MS") or 0.0),
        checkpoint_paths=ckpts,
    )
