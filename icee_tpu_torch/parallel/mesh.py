"""The ``(data, model)`` mesh over ``torch.distributed`` ranks (port of
``icee_tpu/parallel/mesh.py``).

One process per card.  The world's ranks lay out row-major over the mesh
shape ``(n_data, n_model)``, as JAX reshapes its device list: rank ``r``
sits at data coordinate ``r // n_model`` and model coordinate ``r %
n_model``.  Two families of process groups follow:

- the **data group** of a rank: the ranks that hold the same model shard
  (same model coordinate).  Gradients, the packed-mean token counts and the
  BatchNorm statistics are summed over it;
- the **model group**: the ranks that hold the same data shard (same data
  coordinate).  The vocabulary dimension of the embedding and the output
  head is split over it (:func:`decoder_param_shardings`), and the
  vocab-parallel embedding and CE sum over it.

A group of one rank is never created; its collectives are no-ops, so a
``(1, 1)`` mesh computes what a single process computes, bit for bit.

JAX's ``kernel_shard_map`` has no counterpart: with one process per card
each rank already runs the kernels on its own shard.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

VOCAB_ROWS = ("B", "embed")           # (V, E) embeddings: rows split
VOCAB_COLS = ("C_w", "linear_w")      # (H, V) heads: columns split
VOCAB_VEC = ("C_b", "linear_b")       # (V,) head biases


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a ``(n_data, n_model)`` mesh: its coordinates,
    the two process groups (None where a group would hold one rank), the
    card (or CPU) it computes on and the backend of its collectives."""

    shape: Tuple[int, int]
    rank: int
    data_group: Optional[object]
    model_group: Optional[object]
    device: torch.device
    backend: str

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes logs, metrics and checkpoints."""
        return self.rank == 0


def data_shards(mesh: Optional[Mesh]) -> int:
    """Size of the mesh's data axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_data


def model_shards(mesh: Optional[Mesh]) -> int:
    """Size of the mesh's model axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.n_model


def default_backend(device) -> str:
    """NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """This process's device: for CUDA its local rank's card (``LOCAL_RANK``
    as torchrun sets it, else the world rank), modulo the cards, so two
    ranks on a one-card machine share card 0."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def make_mesh(shape: Optional[Tuple[int, int]] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """Build this rank's ``(data, model)`` mesh over the initialized world.

    Default: every rank on the data axis (pure DP), as JAX's.  Every rank
    must call this with the same shape: ``new_group`` is collective, and
    the groups are created in the same order on each rank."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(init_distributed, or torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks")
    n_data, n_model = shape
    data_group = model_group = None
    for d in range(n_data):                    # ranks sharing a data shard
        if n_model > 1:
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = g
    for m in range(n_model):                   # ranks sharing a model shard
        if n_data > 1:
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                data_group = g
    return Mesh(shape, rank, data_group, model_group, rank_device(device),
                backend or dist.get_backend())


def decoder_param_shardings(params: dict, mesh: Mesh) -> dict:
    """Which dimension of each decoder leaf is split over the model axis:
    an int, or None where the leaf replicates.

    JAX's rule (``icee_tpu/parallel/mesh.py:88-115``): leaves named ``B`` /
    ``embed`` split their rows, ``C_w`` / ``linear_w`` their columns,
    ``C_b`` / ``linear_b`` their one dimension, where that dimension (the
    vocabulary) divides the model axis; everything else, and a vocabulary
    that does not divide, replicates."""
    tp = mesh.n_model if isinstance(mesh, Mesh) else int(mesh)

    def spec(name, leaf):
        if isinstance(leaf, dict):
            return {k: spec(k, v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(spec(name, v) for v in leaf)
        if name in VOCAB_ROWS and leaf.ndim >= 2 and leaf.shape[0] % tp == 0:
            return 0
        if name in VOCAB_COLS and leaf.ndim >= 2 and \
                leaf.shape[-1] % tp == 0:
            return leaf.ndim - 1
        if name in VOCAB_VEC and leaf.ndim == 1 and leaf.shape[0] % tp == 0:
            return 0
        return None

    return {k: spec(k, v) for k, v in params.items()}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda") -> bool:
    """Multi-process start-up -> whether a process group is up.

    With JAX's three flags: ``init_process_group`` over
    ``tcp://<coordinator_address>``.  Without them, the environment that
    ``torch.distributed.run`` (torchrun) sets (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).  With neither, a
    no-op, as JAX's ``init_distributed``.  An initialized group is kept.
    The backend follows ``device`` (NCCL for CUDA, gloo for the CPU) unless
    ``backend`` names one; on CUDA this rank's card is made current first."""
    if dist.is_initialized():
        return True
    env = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if coordinator_address is None and not env:
        return False
    backend = backend or default_backend(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        rank, world = int(process_id), int(num_processes)
        init = f"tcp://{coordinator_address}"
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device, rank))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank)
    return True
