"""SentiCap solvers with the reference's exact math (port of
``icee_tpu/senticap/solver.py``, which builds them as optax transforms;
here they are plain functions on tensors, as ``train/optim.py`` is).

Parity target: ``mrnn_solver.py:11-51`` — RMSProp and Adadelta with fudge
factor 1e-8, applied to gradients that are first divided by the batch size
and clipped to +/-GRAD_CLIP_SIZE (``mrnn_switched.py:1122-1128``).  The
divisor is ``conf["batch_size_val"]`` (200), not the batch actually fed:
the reference's quirk, kept.

RMSProp: ``cache = decay*cache + (1-decay)*g^2; p -= lr * g / sqrt(cache+ff)``
Adadelta: ``gsq = rho*gsq + (1-rho)*g^2;
           d = -(sqrt(dsq+ff)/sqrt(gsq+ff)) * g;
           dsq = rho*dsq + (1-rho)*d^2; p += d``

Parameters are dicts of tensors, updated IN PLACE by :meth:`Solver.update`.
A trainable mask (name -> bool) freezes the False leaves: they get a zero
update and keep no solver state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from icee_tpu_torch.senticap.config import ADADELTA, RMSPROP

FF = 1e-8


def _scale_and_clip(grads: Dict[str, torch.Tensor], batch_size: float,
                    clip: float) -> Dict[str, torch.Tensor]:
    """g / batch_size, clamped to +-clip."""
    return {k: torch.clamp(g / batch_size, -clip, clip)
            for k, g in grads.items()}


def rmsprop(grads, state, learning_rate: float, decay: float):
    """-> (updates, new state); ``state`` is ``{"cache": {name: tensor}}``."""
    cache = {k: state["cache"][k] * decay + (1.0 - decay) * g * g
             for k, g in grads.items()}
    updates = {k: -(learning_rate * g) / torch.sqrt(cache[k] + FF)
               for k, g in grads.items()}
    return updates, {"cache": cache}


def adadelta(grads, state, rho: float):
    """-> (updates, new state); ``state`` is ``{"grad_sq", "delta_sq"}``."""
    gsq = {k: rho * state["grad_sq"][k] + (1 - rho) * g * g
           for k, g in grads.items()}
    deltas = {k: -(torch.sqrt(state["delta_sq"][k] + FF)
                   / torch.sqrt(gsq[k] + FF)) * g for k, g in grads.items()}
    dsq = {k: rho * state["delta_sq"][k] + (1 - rho) * d * d
           for k, d in deltas.items()}
    return deltas, {"grad_sq": gsq, "delta_sq": dsq}


class Solver:
    """g / batch_size_val -> clip -> RMSProp or Adadelta, optionally masked
    to a trainable subset (the switch parameters of ``train_joint``)."""

    def __init__(self, conf: dict,
                 trainable_mask: Optional[Dict[str, bool]] = None):
        if conf["GRAD_METHOD"] not in (RMSPROP, ADADELTA):
            raise ValueError(f"unknown GRAD_METHOD {conf['GRAD_METHOD']}")
        self.method = conf["GRAD_METHOD"]
        self.batch_size = float(conf["batch_size_val"])
        self.clip = float(conf["GRAD_CLIP_SIZE"])
        self.learning_rate = conf["learning_rate"]
        self.decay, self.rho = conf["decay"], conf["rho"]
        self.trainable_mask = trainable_mask

    def trainable_keys(self, params) -> list:
        """The names of the leaves this solver updates."""
        mask = self.trainable_mask
        return [k for k in params if mask is None or mask[k]]

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        keys = self.trainable_keys(params)
        if self.method == RMSPROP:
            return {"cache": {k: torch.zeros_like(params[k]) for k in keys}}
        return {"grad_sq": {k: torch.zeros_like(params[k]) for k in keys},
                "delta_sq": {k: torch.zeros_like(params[k]) for k in keys}}

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]], state: dict,
               params: Dict[str, torch.Tensor]) -> dict:
        """Apply one step to ``params`` in place (None grads count as zero;
        frozen leaves are left as they are) -> the new solver state."""
        keys = self.trainable_keys(params)
        g = {k: torch.zeros_like(params[k]) if grads.get(k) is None
             else grads[k] for k in keys}
        g = _scale_and_clip(g, self.batch_size, self.clip)
        if self.method == RMSPROP:
            updates, state = rmsprop(g, state, self.learning_rate,
                                     self.decay)
        else:
            updates, state = adadelta(g, state, self.rho)
        for k in keys:
            params[k].add_(updates[k])
        return state


def make_solver(conf: dict, trainable_mask: Optional[Dict[str, bool]] = None
                ) -> Solver:
    """Full update pipeline: g/batch -> clip -> RMSProp/Adadelta, optionally
    restricted to a trainable subset."""
    return Solver(conf, trainable_mask)
