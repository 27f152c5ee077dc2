"""Train state and optimizers (counterpart of
``tauv_vision_tpu/train/state.py``).

``adam_with_clip`` is optax's ``chain(clip_by_global_norm(max_norm),
adam(lr))`` and ``warmup_adam`` its ``chain(clip_by_global_norm,
scale_by_adam, scale_by_learning_rate(linear_schedule(0, lr, warmup)))``,
with optax's f32 arithmetic:

- the clip scales every gradient by ``max_norm / norm`` only when the
  global norm reaches ``max_norm`` (optax's select, written as ``g / norm
  * max_norm``; ``torch.nn.utils.clip_grad_norm_`` would divide by ``norm
  + 1e-6`` at every step), on the device, without a host sync;
- Adam: m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v, the update lr *
  m_hat / (sqrt(v_hat) + eps) with eps outside the root, b1 0.9, b2
  0.999, eps 1e-8, and the bias corrections 1 - b^t computed in f32 as
  optax computes them.  ``torch.optim.Adam`` has the same formula but
  takes 1 - b^t in f64: optax's f32 1 - 0.999 is 1.3e-5 off, which moves
  an update by ~1e-5 relative, so it is replaced by ``ClippedAdam``;
- the warm-up's learning rate at the t-th update (t from 0) is optax's
  ``(0 - lr) (1 - min(t, warmup) / warmup) + lr`` in f32, every operand
  rounded to f32 first, so the first update moves nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8


def _f32(value) -> float:
    """``value`` rounded to f32, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float32))


class ClippedAdam(torch.optim.Optimizer):
    """Adam after global-norm clipping, with an optional linear warm-up;
    its state dict holds the moments, the update count and the settings."""

    def __init__(self, params, lr: float, max_norm: float, warmup_steps: int = 0):
        super().__init__(params, dict(lr=float(lr), max_norm=float(max_norm),
                                      warmup_steps=int(warmup_steps), count=0))

    @torch.no_grad()
    def clip_(self) -> None:
        """Clip every gradient in place by the global norm."""
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        max_norm = self.param_groups[0]["max_norm"]
        keep = norm < max_norm
        torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))

    def _learning_rate(self, group) -> float:
        lr, warmup = group["lr"], group["warmup_steps"]
        if warmup <= 0:
            return lr
        frac = 1.0 - _f32(min(group["count"], warmup)) / warmup
        return _f32(_f32(_f32(-lr) * _f32(frac)) + _f32(lr))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedAdam takes no closure")
        self.clip_()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            step_size = -self._learning_rate(group)
            group["count"] += 1
            bc1 = _f32(1.0 - _f32(_f32(B1) ** group["count"]))
            bc2 = _f32(1.0 - _f32(_f32(B2) ** group["count"]))
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            torch._foreach_mul_(mus, B1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - B1))
            squares = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(squares, 1.0 - B2)
            torch._foreach_mul_(nus, B2)
            torch._foreach_add_(nus, squares)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, EPS)
            updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            torch._foreach_mul_(updates, step_size)
            torch._foreach_add_(params, updates)


def adam_with_clip(params, lr: float, grad_max_norm: float) -> ClippedAdam:
    """Adam after global-norm clipping, the reference's optimizer recipe."""
    return ClippedAdam(params, lr, grad_max_norm)


def warmup_adam(params, lr: float, warmup_steps: int, grad_max_norm: float) -> ClippedAdam:
    """Adam with a linear warm-up of the learning rate from 0 over
    ``warmup_steps`` updates, after global-norm clipping."""
    return ClippedAdam(params, lr, grad_max_norm, max(warmup_steps, 1))


@dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
