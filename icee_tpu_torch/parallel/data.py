"""Each rank's share of the data (port of ``icee_tpu/parallel/data.py``).

Every rank builds the same global batch from the same seeded loader (host
or device-resident) and computes on its data coordinate's contiguous rows
of it (:func:`local_rows`), the counterpart of JAX's ``global_batch``,
which assembles a mesh-spanning array from each host's rows.
:func:`shard_examples` is JAX's per-host split of a dataset, copied.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist


def shard_examples(examples: Sequence, process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> list:
    """The contiguous slice of the dataset this process is responsible
    for: near-equal contiguous slices, the last one shorter."""
    on = dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None \
        else process_count
    per = -(-len(examples) // pc)
    return list(examples[pi * per : (pi + 1) * per])


def row_slice(batch: int, mesh) -> slice:
    """This data rank's contiguous rows of a global batch of ``batch``
    rows; the batch must divide by the data axis."""
    if mesh is None or mesh.n_data == 1:
        return slice(0, batch)
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} must divide by the data-axis size "
                         f"{mesh.n_data} for even batch sharding")
    per = batch // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def local_rows(batch, mesh):
    """This data rank's rows of each batch-leading tensor (or array) in
    ``batch`` (one tensor, or a tuple / list of them; None stays None)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(local_rows(x, mesh) for x in batch)
    if batch is None or mesh is None or mesh.n_data == 1:
        return batch
    return batch[row_slice(batch.shape[0], mesh)]


def check_batch_sizes(tcfg, mesh, exc=ValueError) -> None:
    """Raise ``exc`` with the JAX CLI's message unless both batch sizes
    divide by the mesh's data axis."""
    for name in ("caption_batch_size", "language_batch_size"):
        bs = getattr(tcfg, name)
        if bs % mesh.n_data:
            raise exc(f"--{name} {bs} must divide by the data-axis size "
                      f"{mesh.n_data} for even batch sharding")
