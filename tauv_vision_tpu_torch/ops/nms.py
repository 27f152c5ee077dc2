"""Batched YOLACT Fast-NMS (counterpart of ``tauv_vision_tpu/ops/nms.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from tauv_vision_tpu_torch.ops.boxes import iou_matrix


def fast_nms(
    classification: torch.Tensor,
    box: torch.Tensor,
    top_k: int,
    iou_threshold: float,
    confidence_threshold: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fast-NMS over decoded boxes.

    Args:
      classification: [B, N, C+1] class logits (channel 0 = background).
      box: [B, N, 4] decoded (y, x, h, w) boxes.
    Returns:
      keep_index: [B, top_k] int64 indices into N, confidence-sorted
        (ties in ascending index order, as ``jax.lax.top_k``).
      keep: [B, top_k] bool mask of surviving detections.
    """
    confidence = torch.softmax(classification, dim=-1)
    max_confidence = confidence[..., 1:].amax(dim=-1)  # [B, N]
    sorted_conf, order = torch.sort(
        max_confidence, dim=1, descending=True, stable=True
    )
    top_conf, top_idx = sorted_conf[:, :top_k], order[:, :top_k]
    top_box = torch.gather(box, 1, top_idx[..., None].expand(-1, -1, 4))
    iou = torch.triu(iou_matrix(top_box, top_box), diagonal=1)
    iou_max = iou.amax(dim=-2)  # worst overlap with a higher-confidence box
    keep = (iou_max <= iou_threshold) & (top_conf >= confidence_threshold)
    return top_idx, keep
