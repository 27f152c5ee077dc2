"""Gather from dense maps (counterpart of ``tauv_vision_tpu/ops/heatmap.py``;
only what the serving decode needs)."""

from __future__ import annotations

import torch


def gather_at_cells(feature: torch.Tensor, out_index: torch.Tensor) -> torch.Tensor:
    """Per-object vectors from a dense map.

    Args:
      feature:   [B, H, W, C]
      out_index: [B, N, 2] integer (y, x) cell indices.
    Returns:
      [B, N, C]
    """
    b, h, w, c = feature.shape
    flat = feature.reshape(b, h * w, c)
    idx = (out_index[..., 0] * w + out_index[..., 1]).long()  # [B, N]
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
