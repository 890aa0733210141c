"""Data and vocab-dimension tensor parallelism over ``torch.distributed``
(port of ``icee_tpu/parallel/``): one process per card, a ``(data,
model)`` mesh of process groups (:mod:`.mesh`), the collectives GSPMD
inserts in the JAX package written out (:mod:`.collectives`), the trees'
placement (:mod:`.train`), each rank's rows (:mod:`.data`), a world of
spawned ranks (:mod:`.launch`) and the dry run (:mod:`.dryrun`)."""

from icee_tpu_torch.parallel.mesh import (Mesh, decoder_param_shardings,
                                          init_distributed, make_mesh)
