"""Load the reference's FULL-MODULE torch pickles without its source code
(copy of ``icee_tpu/checkpoint/torch_pickle.py``).

The reference's primary checkpoint format pickles entire ``nn.Module``
objects (+ optimizers) into ``{MODE}[_BEST]_checkpoint_{name}.pth.tar``
(``utils.py:63-90``); unpickling normally requires the original ``model.py``
classes on the path (the reference itself needs
``torch.nn.Module.dump_patches=True``, ``evaluator.py:37-38``).

This module unpickles those artifacts WITHOUT the reference classes: any
missing class resolves to a stub that records its attributes, and the
state_dict is reconstructed by walking torch's ``_parameters`` /
``_buffers`` / ``_modules`` object graph — producing exactly the names the
import shims in :mod:`icee_tpu_torch.checkpoint.torch_import` expect.
"""

from __future__ import annotations

import io
import pickle
from collections import OrderedDict
from typing import Any, Dict


class _StubModule:
    """Stands in for any unimportable class in the pickle; behaves enough
    like ``nn.Module`` for state_dict reconstruction."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def __setstate__(self, state) -> None:
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def load_torch_pickle(path: str) -> Any:
    """``torch.load`` with missing classes stubbed."""
    import types

    import torch

    # torch.load(pickle_module=...) wants a module-like object exposing
    # Unpickler and load
    mod = types.ModuleType("icee_stub_pickle")

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return type(f"Stub_{name}", (_StubModule,), {})

    mod.Unpickler = Unpickler
    mod.load = pickle.load
    return torch.load(path, map_location="cpu", pickle_module=mod,
                      weights_only=False)


def module_state_dict(obj: Any, prefix: str = "") -> "OrderedDict":
    """Reconstruct a state_dict by walking the (possibly stubbed) module
    graph: ``_parameters`` + ``_buffers`` locally, ``_modules`` recursively —
    the same traversal torch's ``nn.Module.state_dict`` performs."""
    out: "OrderedDict" = OrderedDict()
    d = getattr(obj, "__dict__", {})
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = p.detach() if hasattr(p, "detach") else p
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None:
            out[prefix + name] = b
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(module_state_dict(child, prefix + name + "."))
    return out


def load_state_dict(path: str) -> Dict[str, Any]:
    """A reference torch checkpoint -> its state dict: a state-dict pickle,
    or a whole module pickled (its class need not be importable)."""
    obj = load_torch_pickle(path)
    if hasattr(obj, "state_dict"):
        return obj.state_dict()
    if "_parameters" in getattr(obj, "__dict__", {}):
        return module_state_dict(obj)
    return obj


def load_reference_full_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference full checkpoint -> {'epoch', 'bleu-4',
    'epochs_since_improvement', 'encoder_state', 'decoder_state'} with the
    module pickles flattened to state_dicts ready for the import shims."""
    blob = load_torch_pickle(path)
    out: Dict[str, Any] = {}
    for key in ("epoch", "epochs_since_improvement", "bleu-4"):
        if isinstance(blob, dict) and key in blob:
            out[key] = blob[key]
    if isinstance(blob, dict):
        if "encoder" in blob:
            out["encoder_state"] = module_state_dict(blob["encoder"])
        if "decoder" in blob:
            out["decoder_state"] = module_state_dict(blob["decoder"])
    return out
