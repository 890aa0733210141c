"""A world of ranks spawned from one process: the CPU tests' gloo worlds
and the dry run (:mod:`icee_tpu_torch.parallel.dryrun`).

:func:`spawn` starts ``world`` processes (the ``spawn`` start method), each
initializing the process group through a file store in ``workdir`` (no
TCP port, so concurrent worlds never collide), building the mesh and
calling ``target(mesh, payload)``; the payload reaches the ranks, and each
rank's return value comes back, through a pickle in ``workdir``.
``target`` is pickled by its import path, so it must be a module-level
function of an importable module.  Training
and the CLIs on the card start their ranks with ``torch.distributed.run``
instead (README).
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from icee_tpu_torch.parallel.mesh import default_backend, make_mesh


def _rank_main(rank: int, target: Callable, world: int, workdir: str,
               shape, device: str, backend: str) -> None:
    torch.set_num_threads(1)    # the CPU tests compare float32 bits
    with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    dist.init_process_group(backend,
                            init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(shape, device=device, backend=backend)
        out = target(mesh, payload)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():          # a CLI's run takes it down
            dist.barrier()
            dist.destroy_process_group()


def spawn(target: Callable, world: int, payload=None, *, workdir: str,
          shape: Optional[Tuple[int, int]] = None, device: str = "cpu",
          backend: Optional[str] = None) -> List:
    """Run ``target(mesh, payload)`` on each rank of a new world of
    ``world`` processes (one CPU thread each) on a ``shape`` mesh (default
    ``(world, 1)``) -> the ranks' return values in rank order.  A rank that
    raises ends the others and re-raises here with its traceback."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    backend = backend or default_backend(device)
    # through a file, not the processes' arguments: a start blocks until its
    # process has read them, and that comes after its imports, so large
    # arguments would start the ranks one after another
    with open(os.path.join(workdir, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                       args=(target, world, workdir, shape, device,
                             backend))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
