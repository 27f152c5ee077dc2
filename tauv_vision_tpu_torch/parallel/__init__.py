"""Data parallelism over ranks of a process group (counterpart of
``tauv_vision_tpu/parallel``): see ``mesh.py`` and ``distributed.py``."""

from tauv_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    create_mesh,
    parallel,
    pmax,
    psum,
    replicate,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "create_mesh",
    "parallel",
    "pmax",
    "psum",
    "replicate",
    "shard_batch",
]
