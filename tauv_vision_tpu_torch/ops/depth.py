"""Inverse-sigmoid depth codec and its loss (counterpart of
``tauv_vision_tpu/ops/depth.py``).

The network emits a raw logit; the decoded depth is ``1/sigmoid(logit)
- 1``, which maps (-inf, inf) to (0, inf).
"""

from __future__ import annotations

import torch


def depth_decode(prediction: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sigmoid(prediction) - 1.0


def depth_encode(depth: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`depth_decode` (logit of 1/(depth+1))."""
    return torch.logit(1.0 / (depth + 1.0))


def depth_loss(prediction: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Elementwise L1 between the decoded depth and the truth."""
    return torch.abs(depth_decode(prediction) - truth)
