"""Adam with the reference's update semantics (port of
``icee_tpu/train/optim.py``'s ``make_adam``, ``get_lr``, ``decay_lr``,
``style_slice_zero`` and ``make_style_adam``).

Reference recipe: Adam(lr, betas=(0.9, 0.999), eps=1e-8) with an
elementwise gradient clamp applied *before* the step (``utils.py:51-60``
clamps ``param.grad`` in place), plus plateau-driven LR decay x0.8
(``utils.py:114-124``).  The update is optax's: ``m_hat / (sqrt(v_hat) +
eps)`` scaled by ``-lr``.

Parameters are trees (dicts, lists, tuples) of tensors, updated IN PLACE.
Every leaf is updated, including leaves whose gradient is zero or None this
step (their moments still decay), as optax does over a dense pytree.  A
``param_mask`` (same tree of bools, or one bool for a whole subtree) freezes
the False leaves: they get zero updates and keep no moments; it may also be
a function of the parameter tree that returns such a mask.  A
``grad_transform`` (gradient tree -> gradient tree) runs before the clamp.
The learning rate lives in ``state.hyperparams["learning_rate"]`` and may
change between steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch

from icee_tpu_torch.core.config import TrainConfig


def tree_leaves(tree) -> List[Any]:
    """Leaves of a dict/list/tuple tree in a fixed order (dict insertion
    order); None counts as a leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _mask_leaves(mask, tree) -> List[bool]:
    """Broadcast a (prefix) bool mask over ``tree``'s leaves."""
    if isinstance(mask, bool):
        return [mask] * len(tree_leaves(tree))
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _mask_leaves(mask[k], v)]
    if isinstance(tree, (list, tuple)):
        return [x for m, v in zip(mask, tree) for x in _mask_leaves(m, v)]
    return [bool(mask)]


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[Optional[torch.Tensor]]   # per leaf; None for frozen leaves
    nu: List[Optional[torch.Tensor]]
    hyperparams: dict


class Adam:
    """[grad_transform ->] clip(grad_clip) -> Adam(b1, b2, eps), optionally
    masked."""

    def __init__(self, learning_rate: float, b1: float, b2: float,
                 eps: float, clip: float, param_mask=None,
                 grad_transform: Optional[Callable] = None):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps, self.clip = b1, b2, eps, clip
        self.param_mask = param_mask
        self.grad_transform = grad_transform

    def _trainable(self, params) -> List[bool]:
        if self.param_mask is None:
            return [True] * len(tree_leaves(params))
        mask = self.param_mask
        return _mask_leaves(mask(params) if callable(mask) else mask, params)

    def init(self, params) -> AdamState:
        leaves = tree_leaves(params)
        mu = [torch.zeros_like(p) if t else None
              for p, t in zip(leaves, self._trainable(params))]
        nu = [None if m is None else torch.zeros_like(m) for m in mu]
        return AdamState(0, mu, nu, {"learning_rate": self.learning_rate})

    @torch.no_grad()
    def update(self, grads, state: AdamState, params) -> AdamState:
        """Apply one step to ``params`` in place; ``grads`` has the same
        tree structure (None leaves are zero gradients)."""
        leaves = tree_leaves(params)
        if self.grad_transform is not None:
            grads = self.grad_transform(grads)
        g_leaves = tree_leaves(grads)
        if len(g_leaves) != len(leaves):
            raise ValueError(f"{len(g_leaves)} gradient leaves for "
                             f"{len(leaves)} parameters")
        state.count += 1
        lr = float(state.hyperparams["learning_rate"])
        bc1 = 1.0 - self.b1 ** state.count
        bc2 = 1.0 - self.b2 ** state.count
        live = [i for i, m in enumerate(state.mu) if m is not None]
        if not live:
            return state                       # everything frozen
        ps = [leaves[i] for i in live]
        mus = [state.mu[i] for i in live]
        nus = [state.nu[i] for i in live]
        gs = [torch.zeros_like(leaves[i]) if g_leaves[i] is None
              else g_leaves[i].clamp(-self.clip, self.clip) for i in live]
        # one multi-tensor launch per operation over every trainable leaf
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - self.b1))
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(
            torch._foreach_mul(gs, gs), 1.0 - self.b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(ps, upd)            # frozen leaves: zero update
        return state


def make_adam(learning_rate: float, tcfg: Optional[TrainConfig] = None,
              grad_clip: Optional[float] = None, param_mask=None) -> Adam:
    """clip(grad_clip) -> Adam, optionally masked to a parameter subset."""
    tcfg = tcfg or TrainConfig()
    clip = tcfg.grad_clip if grad_clip is None else grad_clip
    return Adam(learning_rate, tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps,
                clip, param_mask)


def get_lr(opt_state: AdamState) -> float:
    return float(opt_state.hyperparams["learning_rate"])


def decay_lr(opt_state: AdamState, factor: float) -> float:
    """x``factor`` LR decay (``utils.py:114-124``); mutates the state's
    learning rate and returns the new value."""
    new = opt_state.hyperparams["learning_rate"] * factor
    opt_state.hyperparams["learning_rate"] = new
    return float(new)


STYLE_LEAVES = ("S_w", "S_b")


def style_slice_zero(style_id: int, style_leaf_names=STYLE_LEAVES
                     ) -> Callable:
    """Gradient pre-transform zeroing every style slice except ``style_id``
    on the stacked ``(num_styles, ...)`` leaves named ``style_leaf_names``:
    the paper regime's per-emotion optimizers (``train.py:135-150``) on the
    stacked layout.  As the optimizer's ``grad_transform`` it runs before
    the clamp, so the other styles' moments stay exactly 0."""

    def transform(grads):
        if isinstance(grads, dict):
            out = {}
            for k, g in grads.items():
                if k in style_leaf_names and isinstance(g, torch.Tensor):
                    onehot = torch.zeros((g.shape[0],) + (1,) * (g.dim() - 1),
                                         dtype=g.dtype, device=g.device)
                    onehot[style_id] = 1.0
                    out[k] = g * onehot
                else:
                    out[k] = transform(g)
            return out
        if isinstance(grads, (list, tuple)):
            return type(grads)(transform(g) for g in grads)
        return grads

    return transform


def _style_mask(params):
    """True on the style tensors, False on every other leaf."""
    if isinstance(params, dict):
        return {k: (k in STYLE_LEAVES) if isinstance(v, torch.Tensor)
                else _style_mask(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_style_mask(v) for v in params)
    return False


def make_style_adam(learning_rate: float, style_id: int,
                    tcfg: Optional[TrainConfig] = None) -> Adam:
    """Per-emotion Adam over one style's S slice (the T1 regime): the
    other slices' gradients zeroed before the clamp, and every leaf that is
    not a style tensor frozen."""
    tcfg = tcfg or TrainConfig()
    return Adam(learning_rate, tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps,
                tcfg.grad_clip, param_mask=_style_mask,
                grad_transform=style_slice_zero(style_id))
