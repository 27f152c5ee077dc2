"""Spawned ranks' functions for the data-parallel tests
(``parallel.distributed.spawn`` pickles them by import path, and a
spawned rank imports this module and the port, never JAX)."""

from __future__ import annotations

import importlib
from typing import List

import numpy as np
import torch
from torch import nn

from tauv_vision_tpu_torch.parallel.distributed import global_array_from_host_local
from tauv_vision_tpu_torch.parallel.mesh import Mesh, replicate


def mesh_checks(mesh: Mesh) -> dict:
    """A spawned rank's check of the mesh's collectives on small tensors:
    each rank's values and what they should be (``gathered`` and
    ``want_gathered`` and so on), compared by the caller."""
    n, r = mesh.size, mesh.rank
    rows = [torch.arange(6, dtype=torch.float32).reshape(3, 2) + 100 * k for k in range(n)]
    gathered = global_array_from_host_local(rows[r].to(mesh.device), mesh)
    flags = [torch.tensor([k % 2 == 0, True, False]) for k in range(n)]
    gathered_bool = global_array_from_host_local(flags[r].to(mesh.device), mesh)

    torch.manual_seed(r)
    model = nn.Sequential(nn.Linear(3, 2), nn.BatchNorm1d(2)).to(mesh.device)
    with torch.no_grad():
        model[1].running_mean.fill_(r)
    replicate(model, mesh)

    weights = torch.arange(1.0, n + 1.0)
    x = (torch.tensor([1.0, 2.0, 3.0]) * (r + 1)).to(mesh.device).requires_grad_()
    y = mesh.psum(x)
    (y * weights[r]).sum().backward()
    return {
        "rank": r,
        "gathered": gathered.cpu().numpy(), "want_gathered": torch.cat(rows).numpy(),
        "gathered_bool": gathered_bool.cpu().numpy(), "want_bool": torch.cat(flags).numpy(),
        "gathered_dtypes": [str(gathered.dtype), str(gathered_bool.dtype)],
        "replicated": {k: v.cpu().numpy() for k, v in model.state_dict().items()},
        "psum": y.detach().cpu().numpy(),
        "want_psum": (torch.tensor([1.0, 2.0, 3.0]) * weights.sum()).numpy(),
        "grad": x.grad.cpu().numpy(), "want_grad": torch.full((3,), float(weights.sum())).numpy(),
        "pmax": mesh.pmax(torch.tensor([float(r), -float(r)]).to(mesh.device)).cpu().numpy(),
        "want_pmax": np.asarray([n - 1.0, 0.0], np.float32),
    }


def run_main(mesh: Mesh, module: str, argv: List[str]) -> dict:
    """A spawned rank's work: ``<module>.main(argv, device=...)`` (a
    training CLI) on the rank's device, in the process group the rank is
    in, as under ``torchrun``; ``{rank}`` in an argument is the rank's
    index.  Returns the final state's step and model weights (on the
    CPU)."""
    state = importlib.import_module(module).main(
        [a.format(rank=mesh.rank) for a in argv], device=mesh.device.type)
    return {"step": state.step,
            "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}
