"""Loss primitives (counterpart of ``tauv_vision_tpu/ops/losses.py``).

- ``focal_loss``: the penalty-reduced CornerNet focal loss, normalised by
  the number of exact-peak pixels;
- ``smooth_l1``: ``F.smooth_l1_loss`` with no reduction;
- ``binary_cross_entropy``: with both the prediction and the target
  clipped to [eps, 1 - eps];
- ``clip``: ``jnp.clip``, two-sided or from below, with its gradient 1/2
  at a bound;
- ``softmax_cross_entropy``: ``F.cross_entropy`` with integer labels and
  no reduction, over the last axis.
"""

from __future__ import annotations

from typing import Optional

import torch

from tauv_vision_tpu_torch.parallel.mesh import psum


def focal_loss(prediction: torch.Tensor, truth: torch.Tensor, alpha: float,
               beta: float, mesh=None) -> torch.Tensor:
    """Penalty-reduced focal loss on probabilities, elementwise (the
    caller sums).

    ``prediction`` is already sigmoided.  Peak pixels are where ``truth``
    is close to 1 (``torch.isclose``'s default tolerances, as
    ``jnp.isclose``'s); N is their count over the whole tensor, and under
    a data ``mesh`` over the global batch (so the ranks' sums add up to
    the global loss).  With N == 0 the negative term is dropped."""
    p = torch.isclose(truth, torch.ones((), dtype=truth.dtype, device=truth.device))
    n = psum(p.sum(), mesh)
    pf = p.to(prediction.dtype)

    log_pred = torch.log(torch.clamp_min(prediction, 1e-4))
    log_one_minus = torch.log(torch.clamp_min(1.0 - prediction, 1e-4))

    loss_p = ((1.0 - prediction) ** alpha) * log_pred * pf
    loss_n = ((1.0 - truth) ** beta) * (prediction ** alpha) * log_one_minus * (1.0 - pf)
    return torch.where(n == 0, -loss_p, -(loss_p + loss_n) / torch.clamp_min(n, 1))


def smooth_l1(prediction: torch.Tensor, truth: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1, elementwise."""
    diff = torch.abs(prediction - truth)
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def clip(x: torch.Tensor, lo: float, hi: Optional[float] = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: minimum(hi, maximum(lo, x)), the bounds
    rounded to x's dtype; with ``hi`` None, from below only (``jnp.clip(x,
    lo)``).  Its gradient is JAX's: 1 inside, 0 outside and 1/2 at a bound
    (``torch.maximum`` splits a tie as ``lax.max`` does; ``torch.clamp``
    would pass all of it)."""
    out = torch.maximum(torch.full((), lo, dtype=x.dtype, device=x.device), x)
    if hi is None:
        return out
    return torch.minimum(torch.full((), hi, dtype=x.dtype, device=x.device), out)


def binary_cross_entropy(prediction: torch.Tensor, truth: torch.Tensor,
                         eps: float = 1e-4) -> torch.Tensor:
    """Elementwise BCE on probabilities, both clipped to [eps, 1 - eps]
    (``clip``)."""
    p = clip(prediction, eps, 1.0 - eps)
    t = clip(truth, eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-element cross entropy with integer labels over the last axis."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]
