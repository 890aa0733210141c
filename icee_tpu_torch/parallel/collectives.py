"""The collectives of the mesh: what GSPMD inserts into the JAX package's
jitted steps, written out (the port's counterpart of the shardings in
``icee_tpu/parallel/``).

Only ``all_reduce`` and ``broadcast`` are used, over the mesh's groups
(:mod:`icee_tpu_torch.parallel.mesh`):

- :func:`copy_to_model` / :func:`reduce_from_model`: Megatron's pair over
  the model group, as autograd functions.  The first is the identity
  forward and sums its gradient; the second sums forward and passes its
  gradient through.  Downstream of the vocab-parallel embedding and CE the
  computation is replicated over the model group, so a sum in both
  directions would multiply the gradient by the group's size;
- :func:`all_reduce_sum`: a sum in both directions, for the BatchNorm
  statistics over the data group, whose downstream rows differ by rank;
- :func:`all_reduce_grads`: the data group's gradient sum, one flattened
  buffer per dtype;
- :class:`VocabShard`: this rank's slice of the vocabulary and the
  embedding lookup, argmax and logsumexp over the split vocabulary.

A group of None (one rank) makes every function here the identity.  Under
gloo a CUDA tensor is reduced through a host copy (gloo's own CUDA
collectives copy through the host too; doing it here keeps MIN, MAX and
int64 on gloo's CPU path).  Under NCCL nothing goes through the host.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

SUM, MAX, MIN = dist.ReduceOp.SUM, dist.ReduceOp.MAX, dist.ReduceOp.MIN


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """In-place all_reduce of a contiguous tensor over ``group`` (no-op
    for None) -> ``t``."""
    if group is None:
        return t
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def reduced(t: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """A reduced copy of ``t`` over ``group`` (``t`` itself for None); no
    gradient."""
    if group is None:
        return t
    return all_reduce_(t.detach().clone().contiguous(), group, op)


def broadcast_(t: torch.Tensor, src: int) -> torch.Tensor:
    """In-place broadcast over the world from rank ``src`` -> ``t``."""
    if _staged(t, None):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over the model ``group``."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over the model ``group`` forward; the gradient passed
    through."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over ``group`` in both directions."""
    return x if group is None else _AllReduceSum.apply(x, group)


def _tensors(tree):
    """The tensor leaves of a dict/list/tuple tree in a fixed order (dict
    insertion order, as ``train/optim.py::tree_leaves``), None leaves
    left out."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [] if tree is None else [tree]


@torch.no_grad()
def all_reduce_grads(grads, group):
    """Sum every gradient leaf of ``grads`` over the data ``group`` in
    place, one flattened buffer per dtype -> ``grads``.  None leaves (a
    parameter the loss does not reach, the same on every rank) stay None."""
    if group is None:
        return grads
    by_dtype = {}
    for g in _tensors(grads):
        by_dtype.setdefault(g.dtype, []).append(g)
    for leaves in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in leaves]), group)
        for g, part in zip(leaves, flat.split([g.numel() for g in leaves])):
            g.copy_(part.view_as(g))
    return grads


def gather_rows(x: torch.Tensor, group, index: int, n: int) -> torch.Tensor:
    """The ``n`` equal row blocks of ``group``'s ranks stacked in rank order
    on every rank: this rank's block ``x`` at ``index``, zeros elsewhere,
    then one sum (an all_gather made of all_reduce).  No gradient."""
    if group is None:
        return x
    rows = x.shape[0]
    out = x.new_zeros((rows * n,) + tuple(x.shape[1:]))
    out[index * rows:(index + 1) * rows] = x
    return all_reduce_(out, group)


class _GatherSlices(torch.autograd.Function):
    """The whole tensor from each model rank's slice along ``dim`` (zeros,
    this rank's slice in place, one sum); the gradient, the same on every
    rank of the group downstream, narrowed back to this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, index, n, group):
        ctx.dim, ctx.index, ctx.size = dim, index, x.shape[dim]
        shape = list(x.shape)
        shape[dim] *= n
        out = x.new_zeros(shape)
        out.narrow(dim, index * x.shape[dim], x.shape[dim]).copy_(x)
        return all_reduce_(out, group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None,
                None, None, None)


class VocabShard:
    """This rank's slice of a vocabulary of ``vocab_size`` split over the
    mesh's model group: ids ``[offset, offset + size)``.  Built by
    :func:`vocab_shard`, which gives None where nothing is split."""

    def __init__(self, group, model_rank: int, n_model: int,
                 vocab_size: int):
        self.group = group
        self.vocab_size = vocab_size
        self.size = vocab_size // n_model
        self.offset = model_rank * self.size

    def local_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Ids shifted into this slice; those outside fall outside [0,
        size), where the CE's row passes find no target."""
        return ids.long() - self.offset

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of the (V, E) embedding whose slice ``table`` this rank
        holds: each rank looks up its own ids, zeros elsewhere, then one
        sum over the model group (:func:`reduce_from_model`)."""
        local = self.local_ids(ids)
        inside = (local >= 0) & (local < self.size)
        rows = table[local.clamp(0, self.size - 1)]
        return reduce_from_model(torch.where(inside[..., None], rows, 0.0),
                                 self.group)

    @torch.no_grad()
    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The first maximum over the whole vocabulary of logits whose
        columns this rank holds: the largest value, then the least global
        id that holds it."""
        vals, idx = logits.max(dim=-1)
        best = reduced(vals, self.group, MAX)
        cand = torch.where(vals == best, idx + self.offset,
                           torch.full_like(idx, self.vocab_size))
        return reduced(cand, self.group, MIN)

    @torch.no_grad()
    def logsumexp(self, lse: torch.Tensor) -> torch.Tensor:
        """Each row's logsumexp over the whole vocabulary from the slices'
        ``lse``: their max, then the sum of exp(lse - max)."""
        m = reduced(lse, self.group, MAX)
        return m + torch.log(reduced(torch.exp(lse - m), self.group))

    def whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole vocabulary's tensor from this rank's slice ``x`` split
        along ``dim``, differentiable (:class:`_GatherSlices`)."""
        return _GatherSlices.apply(x, dim, self.offset // self.size,
                                   self.vocab_size // self.size, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the model group (no gradient)."""
        return reduced(x, self.group)


def vocab_shard(mesh, vocab_size: int) -> Optional[VocabShard]:
    """This rank's :class:`VocabShard` where the vocabulary is split over
    the mesh's model axis (it divides, as in
    :func:`~icee_tpu_torch.parallel.mesh.decoder_param_shardings`), else
    None: every lookup then takes the whole table."""
    if mesh is None or mesh.n_model == 1 or vocab_size % mesh.n_model:
        return None
    return VocabShard(mesh.model_group, mesh.model_rank, mesh.n_model,
                      vocab_size)
