"""Box math on (y, x, h, w) boxes normalised to [0, 1].

Counterpart of ``tauv_vision_tpu/ops/boxes.py`` (the functions the
serving path and the YOLACT loss need).  ``box_to_mask`` is the plain crop of kernel B.
"""

from __future__ import annotations

from typing import Tuple

import torch


def box_to_corners(box: torch.Tensor) -> torch.Tensor:
    """(y, x, h, w) -> (min_y, min_x, max_y, max_x)."""
    cy, cx, h, w = box.unbind(-1)
    return torch.stack((cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2), dim=-1)


def box_encode(
    box: torch.Tensor, anchor: torch.Tensor,
    variances: Tuple[float, float],
) -> torch.Tensor:
    """SSD-style encoding of boxes against anchors, the inverse of
    ``box_decode``: (yx - anchor_yx) / (var0 anchor_hw), log(hw /
    anchor_hw) / var1."""
    g_yx = (box[..., :2] - anchor[..., :2]) / (variances[0] * anchor[..., 2:])
    g_hw = torch.log(box[..., 2:] / anchor[..., 2:]) / variances[1]
    return torch.cat((g_yx, g_hw), dim=-1)


def box_decode(
    box_encoding: torch.Tensor, anchor: torch.Tensor,
    variances: Tuple[float, float],
) -> torch.Tensor:
    """SSD-style decode of box encodings against anchors."""
    yx = anchor[..., :2] + box_encoding[..., :2] * variances[0] * anchor[..., 2:]
    hw = anchor[..., 2:] * torch.exp(box_encoding[..., 2:] * variances[1])
    return torch.cat((yx, hw), dim=-1)


def iou_matrix(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [..., N, 4] and [..., M, 4] -> [..., N, M]."""
    ca = box_to_corners(box_a)
    cb = box_to_corners(box_b)
    y_min = torch.maximum(ca[..., :, None, 0], cb[..., None, :, 0])
    x_min = torch.maximum(ca[..., :, None, 1], cb[..., None, :, 1])
    y_max = torch.minimum(ca[..., :, None, 2], cb[..., None, :, 2])
    x_max = torch.minimum(ca[..., :, None, 3], cb[..., None, :, 3])
    inter = (y_max - y_min).clamp(min=0) * (x_max - x_min).clamp(min=0)
    area_a = box_a[..., 2] * box_a[..., 3]
    area_b = box_b[..., 2] * box_b[..., 3]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union


def box_to_mask(box: torch.Tensor, img_size: Tuple[int, int]) -> torch.Tensor:
    """Rasterise boxes [..., 4] into masks [..., H, W].

    A pixel (integer grid coordinate) is inside when
    ``left <= x <= right and top <= y <= bottom`` in pixel units."""
    h_px, w_px = img_size
    y_coords = torch.arange(h_px, dtype=torch.float32, device=box.device)
    x_coords = torch.arange(w_px, dtype=torch.float32, device=box.device)
    cy = box[..., 0:1] * h_px
    cx = box[..., 1:2] * w_px
    bh = box[..., 2:3] * h_px
    bw = box[..., 3:4] * w_px
    in_y = (y_coords >= cy - bh / 2) & (y_coords <= cy + bh / 2)  # [..., H]
    in_x = (x_coords >= cx - bw / 2) & (x_coords <= cx + bw / 2)  # [..., W]
    return (in_y[..., :, None] & in_x[..., None, :]).to(torch.float32)
