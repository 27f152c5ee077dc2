"""The 1-D data mesh over the ranks of a process group (counterpart of
``tauv_vision_tpu/parallel/mesh.py``'s data axis).

The JAX package's mesh is one program over many devices, XLA inserting
the collectives.  Here each rank is a process that sees only its own rows
of the batch, so the collectives are written out: a ``Mesh`` names the
ranks (``size``, this process's ``rank``, its ``device``) and carries
them as methods, so that whatever runs under a mesh learns of it from
the caller.  A train step sums its gradients over the mesh, BatchNorm
sums its batch statistics over it (``models/layers.py``), and the losses
take their normalisers over it, so a step on N ranks is the
single-device step on the global batch.

- ``create_mesh``: the mesh of this process's group, or a mesh of one;
- ``shard_batch``: this rank's rows of a global batch, on its device;
- ``replicate``: a model's parameters and buffers broadcast from rank 0;
- ``Mesh.psum``: an all-reduce sum that autograd sees (backward is the
  all-reduce sum of the gradients), ``Mesh.pmax`` a maximum without one;
- ``psum`` / ``pmax``: the same, the identity without a mesh of more
  than one rank.

A mesh of one rank is the identity everywhere, so every code path under
it is what it is without one.  ``batch_sharding`` and ``replicated`` have
no counterpart to carry: a rank's tensors are its own, and replication is
the broadcast of ``replicate``.  The model axis (``spatial_sharding``,
``has_model_axis``, ``small_map_guard``: width-sharded activations with a
halo exchange around every conv) is not ported.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from tauv_vision_tpu_torch.parallel import distributed

DATA_AXIS = "data"


@dataclasses.dataclass
class CollectiveStats:
    """What a mesh's collectives did: calls and bytes always, host seconds
    while ``timed`` (each collective then waits for the device first, so
    its seconds are its own and not the work queued before it)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


@dataclasses.dataclass
class Mesh:
    """``size`` ranks of the default process group along ``DATA_AXIS``;
    this process is ``rank`` and computes on ``device``."""

    size: int
    rank: int
    device: torch.device
    stats: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    @property
    def shape(self) -> dict:
        """{``DATA_AXIS``: ``size``}, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.size}

    def _run(self, op, tensor: torch.Tensor):
        self.stats.calls += 1
        self.stats.bytes += tensor.numel() * tensor.element_size()
        if not self.stats.timed:
            return op()
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        start = time.perf_counter()
        out = op()
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        self.stats.seconds += time.perf_counter() - start
        return out

    def all_reduce_(self, tensor: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place, no gradient: ``tensor`` becomes its reduction over the
        ranks."""
        self._run(lambda: dist.all_reduce(tensor, op=op), tensor)
        return tensor

    def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
        self._run(lambda: dist.broadcast(tensor, src=src), tensor)
        return tensor

    def barrier(self) -> None:
        dist.barrier()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks; where autograd records, its
        backward is the sum of the ranks' gradients."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _AllReduceSum.apply(x, self)
        return self.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The maximum of ``x`` over the ranks (no gradient)."""
        return self.all_reduce_(x.detach().clone(memory_format=torch.contiguous_format),
                                dist.ReduceOp.MAX)


class _AllReduceSum(torch.autograd.Function):
    """Forward: the all-reduce sum.  Backward: the all-reduce sum of the
    incoming gradients, which is the derivative of the sum over ranks of
    every rank's loss with respect to this rank's input."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


def parallel(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has more than one rank."""
    return mesh is not None and mesh.size > 1


def psum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``mesh.psum(x)``; ``x`` itself without a mesh of more than one
    rank."""
    return mesh.psum(x) if parallel(mesh) else x


def pmax(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``mesh.pmax(x)``; ``x`` itself without a mesh of more than one
    rank."""
    return mesh.pmax(x) if parallel(mesh) else x


def create_mesh(device=None) -> Mesh:
    """The data mesh over every rank of the default process group, this
    process computing on ``device`` (the CPU when None); a mesh of one
    rank when no group is initialised."""
    device = torch.device("cpu" if device is None else device)
    return Mesh(distributed.process_count(), distributed.process_index(), device)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows (``host_local_batch_slice``) of every array leaf
    of a global batch (an array, or a dataclass of arrays with None
    fields), as tensors on the rank's device."""
    def put(x):
        x = torch.as_tensor(x)
        if mesh.size > 1:
            if x.shape[0] % mesh.size:
                raise ValueError(f"global batch {x.shape[0]} not divisible by {mesh.size} "
                                 "ranks")
            per = x.shape[0] // mesh.size
            x = x[mesh.rank * per:(mesh.rank + 1) * per]
        return x.to(mesh.device)

    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: put(getattr(batch, f.name)) for f in dataclasses.fields(batch)
            if getattr(batch, f.name) is not None})
    return put(batch)


@torch.no_grad()
def replicate(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Broadcast every parameter and buffer of ``model`` from rank 0, in
    place, so that every rank starts from rank 0's state; ``model``."""
    if parallel(mesh):
        for t in list(model.parameters()) + list(model.buffers()):
            mesh.broadcast_(t.data)
    return model
