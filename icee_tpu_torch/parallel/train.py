"""Placement of the trainers' trees on the mesh (port of
``icee_tpu/parallel/train.py``).

A decoder lives on each rank as its vocabulary slice
(:func:`shard_decoder`): the leaves that
:func:`~icee_tpu_torch.parallel.mesh.decoder_param_shardings` splits hold
this model rank's rows or columns, every other leaf the whole tensor.
:func:`gather_decoder` puts the whole tree back together on every rank
(for validation, the sample caption, checkpoints); the optimizer states'
moments follow their parameters (:func:`shard_leaves` /
:func:`gather_leaves` over a leaf list).  JAX places the same trees with
``NamedSharding`` and lets GSPMD move them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from icee_tpu_torch.bridge import to_torch
from icee_tpu_torch.parallel.collectives import all_reduce_, broadcast_
from icee_tpu_torch.parallel.mesh import Mesh, decoder_param_shardings
from icee_tpu_torch.train.optim import AdamState, tree_leaves


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def shard_leaf(x: torch.Tensor, dim: Optional[int], mesh: Mesh):
    """This model rank's slice of ``x`` along ``dim`` (a copy; None: the
    whole tensor, copied)."""
    if x is None:
        return None
    if dim is None or mesh.n_model == 1:
        return x.to(mesh.device, copy=True).contiguous()
    size = x.shape[dim] // mesh.n_model
    part = x.narrow(dim, mesh.model_rank * size, size)
    return part.to(mesh.device, copy=True).contiguous()


@torch.no_grad()
def gather_leaf(x: torch.Tensor, dim: Optional[int], mesh: Mesh):
    """The whole tensor from each model rank's slice along ``dim``: every
    slice put in place in a zero buffer, then one sum over the model group
    (None: ``x`` itself)."""
    if x is None or dim is None or mesh.n_model == 1:
        return x
    size = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = size * mesh.n_model
    out = x.new_zeros(shape)
    out.narrow(dim, mesh.model_rank * size, size).copy_(x)
    return all_reduce_(out, mesh.model_group)


def shard_decoder(params, mesh: Mesh) -> dict:
    """Whole decoder (tensors, or numpy as ``bridge.to_numpy`` and the JAX
    package's ``jax.tree.map(np.asarray, ...)`` give it) -> this rank's
    slices on ``mesh.device``."""
    if isinstance(next(iter(tree_leaves(params))), np.ndarray):
        params = to_torch(params)
    return _map2(lambda x, d: shard_leaf(x, d, mesh), params,
                 decoder_param_shardings(params, mesh))


def gather_decoder(params: dict, mesh: Mesh, specs: dict) -> dict:
    """This rank's slices -> the whole decoder, on every rank; ``specs``
    is :func:`decoder_param_shardings` of the whole tree."""
    return _map2(lambda x, d: gather_leaf(x, d, mesh), params, specs)


def shard_leaves(leaves: Sequence, dims: Sequence[Optional[int]],
                 mesh: Mesh) -> list:
    return [shard_leaf(x, d, mesh) for x, d in zip(leaves, dims)]


def gather_leaves(leaves: Sequence, dims: Sequence[Optional[int]],
                  mesh: Mesh) -> list:
    return [gather_leaf(x, d, mesh) for x, d in zip(leaves, dims)]


def map_state(fn, state: AdamState, dims: Sequence[Optional[int]],
              mesh: Mesh) -> AdamState:
    """An Adam state with ``fn`` (:func:`shard_leaves` or
    :func:`gather_leaves`) applied to its moments."""
    return AdamState(state.count, fn(state.mu, dims, mesh),
                     fn(state.nu, dims, mesh), dict(state.hyperparams))


@torch.no_grad()
def broadcast_params(tree, src: int = 0):
    """Every leaf of ``tree`` set to rank ``src``'s, in place, over the
    whole world -> ``tree``."""
    for x in tree_leaves(tree):
        if x is not None:
            broadcast_(x, src)
    return tree


def dp_tp_shape(n_devices: int, tp: int = 2) -> Tuple[int, int]:
    """Pick a (data, model) mesh shape: tp-way tensor parallel when it
    divides the device count, else pure DP."""
    if n_devices % tp == 0 and n_devices >= tp:
        return (n_devices // tp, tp)
    return (n_devices, 1)
