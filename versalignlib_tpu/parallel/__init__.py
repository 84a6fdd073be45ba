"""Multi-device scaling: device meshes + data-parallel alignment.

The reference is single-node shared-memory (OpenMP threads,
DefaultKernel.cpp:45-48); this package is the greenfield distributed layer:
pair batches shard data-parallel over a ``jax.sharding.Mesh`` and results
come back via XLA collectives (NCCL between GPUs).
"""

from versalignlib_tpu.parallel.mesh import make_mesh
from versalignlib_tpu.parallel.distributed import (
    distributed_align_batch,
    distributed_score_batch,
)
from versalignlib_tpu.parallel import multihost

__all__ = [
    "make_mesh",
    "distributed_score_batch",
    "distributed_align_batch",
    "multihost",
]
