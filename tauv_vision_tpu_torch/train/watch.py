"""Per-layer parameter and gradient statistics, the ``wandb.watch``
equivalent (counterpart of ``tauv_vision_tpu/train/watch.py``; the
reference watches gradients and parameters every ``log_freq`` batches,
``yolact/scripts/train.py:480``).

For each trained parameter, under its module path with "/" between the
parts:

  watch/<layer/path>/param_norm, /grad_norm, /grad_absmax

and ``watch/global_grad_norm``, the norm over every gradient, all in
f32 and as tensors on the parameters' device (one host read each when a
writer logs them).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


@torch.no_grad()
def watch_metrics(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The statistics of ``model``'s parameters and their ``.grad``, taken
    before the optimizer's step (the raw gradients, as JAX takes them from
    ``value_and_grad``); a parameter without a gradient is left out."""
    out: Dict[str, torch.Tensor] = {}
    squares = []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        key = name.replace(".", "/")
        g = p.grad.float()
        out[f"watch/{key}/param_norm"] = torch.linalg.vector_norm(p.float())
        out[f"watch/{key}/grad_norm"] = torch.linalg.vector_norm(g)
        out[f"watch/{key}/grad_absmax"] = g.abs().max()
        squares.append(torch.sum(torch.square(g)))
    out["watch/global_grad_norm"] = torch.sqrt(torch.stack(squares).sum())
    return out
