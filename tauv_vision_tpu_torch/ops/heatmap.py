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


def gather_channel_at_cells(feature: torch.Tensor, out_index: torch.Tensor,
                            channel: torch.Tensor) -> torch.Tensor:
    """One channel's vector at each cell: the JAX decode's two
    ``take_along_axis`` (cell, then channel) as one gather.

    Args:
      feature:   [B, H, W, C, D]
      out_index: [B, N, 2] integer (y, x) cell indices.
      channel:   [B, N] integer channel of each cell.
    Returns:
      [B, N, D]
    """
    b, h, w, c, d = feature.shape
    flat = feature.reshape(b, h * w * c, d)
    idx = ((out_index[..., 0] * w + out_index[..., 1]).long() * c + channel.long())
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, d))
