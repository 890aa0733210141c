"""Checkpoint/resume (port of ``icee_tpu/checkpoint/ckpt.py``).

ONE checkpoint holds params + optimizer states + counters, saved as
``{mode}_checkpoint_{name}`` plus a ``{mode}_BEST_checkpoint_{name}`` copy
on improvement: the reference's naming contract (``utils.py:63-90``), the
JAX package's paths.  The JAX package writes orbax, which the port does not
read or write: here each path is a directory holding one ``torch.save``
file, :data:`CKPT_FILE`, written under a temporary name and moved in with
``os.replace``.  Its tensors are saved on the CPU and optimizer states as
plain dicts, so the file loads with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional

import torch

from icee_tpu_torch.train.optim import AdamState

CKPT_FILE = "checkpoint.pt"


@dataclasses.dataclass
class CheckpointState:
    """What a full checkpoint carries (reference ``utils.py:76-84``)."""

    epoch: int
    epochs_since_improvement: dict
    best_bleu4: dict
    params: Any                 # model parameter trees (per family layout)
    opt_states: Any             # optimizer states (AdamState) by name
    extra: Optional[dict] = None

    def as_pytree(self) -> dict:
        return {
            "epoch": int(self.epoch),
            "epochs_since_improvement": {
                k: int(v) for k, v in self.epochs_since_improvement.items()},
            "best_bleu4": {k: float(v) for k, v in self.best_bleu4.items()},
            "params": self.params,
            "opt_states": self.opt_states,
            "extra": self.extra or {},
        }


def _ckpt_path(folder: str, data_name: str, mode: str, best: bool) -> str:
    tag = f"{mode}_BEST_checkpoint_{data_name}" if best else \
        f"{mode}_checkpoint_{data_name}"
    return os.path.abspath(os.path.join(folder, tag))


def is_port_checkpoint(path: str) -> bool:
    """True for a directory written by :func:`save_checkpoint`."""
    return os.path.isfile(os.path.join(path, CKPT_FILE))


def _to_saved(tree):
    """Tensors to the CPU, AdamState to a dict of its fields."""
    if isinstance(tree, AdamState):
        return {"count": int(tree.count), "mu": _to_saved(tree.mu),
                "nu": _to_saved(tree.nu),
                "hyperparams": {k: float(v)
                                for k, v in tree.hyperparams.items()}}
    if isinstance(tree, dict):
        return {k: _to_saved(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_saved(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write(path: str, tree) -> None:
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".ckpt_", dir=path)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(tree, f)
        os.replace(tmp, os.path.join(path, CKPT_FILE))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(
    folder: str,
    data_name: str,
    mode: str,
    state: CheckpointState,
    is_best: bool,
) -> str:
    """Save ``{mode}_checkpoint_{data_name}`` (+ BEST copy when improved)."""
    tree = _to_saved(state.as_pytree())
    path = _ckpt_path(folder, data_name, mode, best=False)
    _write(path, tree)
    if is_best:
        _write(_ckpt_path(folder, data_name, mode, best=True), tree)
    return path


def _read(path: str) -> dict:
    path = os.path.abspath(path)
    if not is_port_checkpoint(path):
        raise ValueError(
            f"{path} holds no {CKPT_FILE}: not a checkpoint written by "
            "icee_tpu_torch.checkpoint.ckpt (the JAX package's orbax "
            "checkpoints are not read by the port)")
    return torch.load(os.path.join(path, CKPT_FILE), map_location="cpu",
                      weights_only=True)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def load_params(path: str, device="cpu") -> dict:
    """A checkpoint's ``params`` subtree (``{"decoder", "head"}``) on
    ``device``: for serving and tooling that need no optimizer state."""
    return _to(_read(path)["params"], device)


def _like(saved, template):
    """``saved`` shaped as ``template``: tensors on the template leaf's
    device, dicts that the template holds as AdamState back to AdamState;
    raises where the structure or a shape differs."""
    if isinstance(template, AdamState):
        return AdamState(int(saved["count"]),
                         _like(saved["mu"], template.mu),
                         _like(saved["nu"], template.nu),
                         dict(saved["hyperparams"]))
    if isinstance(template, dict):
        if set(saved) != set(template):
            raise ValueError(f"checkpoint keys {sorted(saved)} != "
                             f"{sorted(template)}")
        return {k: _like(saved[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(saved) != len(template):
            raise ValueError(f"checkpoint list of {len(saved)} != "
                             f"{len(template)}")
        return type(template)(_like(s, t) for s, t in zip(saved, template))
    if isinstance(template, torch.Tensor):
        if saved is None or tuple(saved.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf {getattr(saved, 'shape', None)}"
                             f" != template {tuple(template.shape)}")
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


def load_checkpoint(path: str, template: Optional[dict] = None) -> dict:
    """Restore a checkpoint tree.  ``template`` (e.g. a fresh
    ``CheckpointState(...).as_pytree()``) checks the structure and shapes,
    places every tensor as its template leaf and brings optimizer states
    back as AdamState; without it the saved tree is returned on the CPU."""
    tree = _read(path)
    if template is None:
        return tree
    out = dict(tree)
    for key in ("params", "opt_states"):
        out[key] = _like(tree[key], template[key])
    return out
