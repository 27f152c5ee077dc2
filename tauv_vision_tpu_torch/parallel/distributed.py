"""Multi-process initialisation, host-local batching and rank launching
(counterpart of ``tauv_vision_tpu/parallel/distributed.py``).

Data parallelism in the port is one process a device (a "rank"), joined
by a ``torch.distributed`` process group: ``torchrun`` starts the ranks
and sets their environment, or :func:`spawn` starts them from Python.
Call :func:`initialize` in each rank before anything collective, build
the mesh (``parallel.mesh.create_mesh``) and feed each rank its
host-local rows of the global batch (:func:`host_local_batch_slice`, the
contract ``data/loader.py``'s sharded ``BatchLoader`` and
``data/grain_loader.py`` implement).

On one process everything is a no-op, so single-process behaviour is
unchanged.

Backends: "nccl" where each rank owns a GPU; "gloo" on the CPU, or where
ranks share one card (NCCL refuses two ranks on one device).  gloo on
CUDA tensors has only ``broadcast``, ``all_reduce`` and ``barrier``, so
everything collective here is built from those
(:func:`global_array_from_host_local` gathers by an all-reduce).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import socket
import tempfile
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
TIMEOUT = timedelta(minutes=10)
RANK_THREADS = 1    # a spawned rank's intra-op threads: the ranks share the host's cores


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def initialize(
    backend: Optional[str] = None,
    address: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> bool:
    """Join a ``torch.distributed`` process group when running
    multi-process.

    Resolution order: explicit arguments, then ``torchrun``'s environment
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Returns
    True when a process group was initialised, False for the
    single-process no-op: no address, or a world of 1.  ``address`` is
    ``host:port``.

    Raises ``ValueError`` when an address is given without the world size
    and the rank, or a group is to be made with no ``backend`` named
    ("nccl" or "gloo"); a failed init raises, it never carries on as a
    single process."""
    if address is None and os.environ.get("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")

    if address is None:
        return False
    if world_size is not None and world_size <= 1:
        return False
    if world_size is None or rank is None:
        raise ValueError(
            "a process group address is set but the world size and rank are missing: set "
            "WORLD_SIZE and RANK (torchrun does) or pass them explicitly")
    if backend not in BACKENDS:
        raise ValueError(f"name the backend, one of {BACKENDS}, got {backend!r}")
    _init_group(backend, address, world_size, rank)
    return True


def _init_group(backend: str, address: str, world_size: int, rank: int) -> None:
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world_size,
                            rank=rank, timeout=TIMEOUT)


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This rank's index on its host (``LOCAL_RANK``, 0 without one)."""
    return _env_int("LOCAL_RANK") or 0


def host_local_batch_slice(global_batch_size: int) -> slice:
    """This process's slice of a batch-axis-sharded global batch: process
    i reads rows [i*b, (i+1)*b) of each global batch."""
    count = process_count()
    if global_batch_size % count:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {count} processes")
    per = global_batch_size // count
    i = process_index()
    return slice(i * per, (i + 1) * per)


def global_array_from_host_local(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global batch, on every rank, from each rank's host-local rows
    ``x`` (every rank holds as many): each rank writes its rows into a
    zeroed global buffer and the buffers are all-reduced.  Adding zeros
    is exact, so the rows arrive bit for bit; booleans travel as uint8.
    The identity without a mesh of more than one rank."""
    if mesh is None or mesh.size == 1:
        return x
    per = x.shape[0]
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = torch.zeros((mesh.size * per,) + tuple(x.shape[1:]), dtype=wire.dtype,
                      device=x.device)
    out[mesh.rank * per:(mesh.rank + 1) * per] = wire
    mesh.all_reduce_(out)
    return out.bool() if x.dtype == torch.bool else out


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend(device: torch.device, ranks_on_host: int) -> str:
    """NCCL where every rank on the host can own a GPU of its own, gloo
    otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, rank_on_host: int) -> torch.device:
    """A rank's device: ``cuda:<rank on host>``, wrapped onto the cards
    there are (ranks share a card where there are fewer), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank_on_host % max(torch.cuda.device_count(), 1))


@dataclasses.dataclass
class _Launch:
    fn: Callable
    args: tuple
    world_size: int
    address: str
    device_type: str
    out_dir: str


def _rank_main(rank: int, launch: _Launch) -> None:
    from tauv_vision_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(RANK_THREADS)
    device = rank_device(launch.device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _init_group("gloo", launch.address, launch.world_size, rank)
    try:
        result = launch.fn(create_mesh(device), *launch.args)
        torch.save(result, pathlib.Path(launch.out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        shutdown()


def spawn(fn: Callable, world_size: int, *args: Any, device: str = "cpu") -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world_size`` fresh processes (the
    ``spawn`` start method), joined by a gloo group on 127.0.0.1, and
    return each rank's result, by rank.

    ``fn`` and ``args`` are pickled by import path: ``fn`` is a
    module-level function of an importable module.  Each rank runs on
    ``device`` ("cpu", or "cuda": rank r on card r, wrapped onto the cards
    there are; gloo, because NCCL refuses two ranks on one card) with
    ``RANK_THREADS`` intra-op threads.  Results travel through
    ``torch.save`` files; a rank that raises makes this raise (the others
    are then stopped).  A world of 1 still makes a group, of one rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="tauv_ranks_") as out_dir:
        launch = _Launch(fn, args, world_size, f"127.0.0.1:{free_port()}", device, out_dir)
        mp.start_processes(_rank_main, args=(launch,), nprocs=world_size, join=True,
                           start_method="spawn")
        return [torch.load(pathlib.Path(out_dir) / f"rank{r}.pt", weights_only=False)
                for r in range(world_size)]


def join_data_mesh(device: torch.device):
    """A training CLI's data mesh: ``(mesh, joined)``.

    Under ``torchrun`` with ``WORLD_SIZE`` > 1, join the process group from
    the environment (NCCL where every rank on the host can own a card,
    gloo otherwise; ``joined`` is True, and the caller leaves with
    ``shutdown``), or use the group this process is in already (``spawn``'s);
    the mesh is over its ranks, on this rank's device of ``device``'s type
    (``rank_device`` of ``LOCAL_RANK``, or the current card where no
    ``LOCAL_RANK`` is set).  ``(None, False)`` for one process or a group
    of one."""
    from tauv_vision_tpu_torch.parallel.mesh import create_mesh

    joined = False
    if not dist.is_initialized():
        world = _env_int("WORLD_SIZE") or 1
        if world <= 1:
            return None, False
        joined = initialize(default_backend(device, _env_int("LOCAL_WORLD_SIZE") or world))
    if dist.get_world_size() == 1:
        return None, joined
    if device.type == "cuda" and _env_int("LOCAL_RANK") is None:
        rank_dev = torch.device("cuda", torch.cuda.current_device())   # set by the launcher
    else:
        rank_dev = rank_device(device.type, local_rank())
    if rank_dev.type == "cuda":
        torch.cuda.set_device(rank_dev)
    return create_mesh(rank_dev), joined
