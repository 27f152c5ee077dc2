"""Gaussian heatmap and keypoint-affinity targets, and gathers from dense
maps (counterpart of ``tauv_vision_tpu/ops/heatmap.py``).

Since all objects share one sigma, max_n exp(-d_n^2 / 2 s^2) equals
exp(-min_n d_n^2 / 2 s^2), so a class's heatmap is a min of squared
distances over its (padded, masked) objects: one broadcast reduction over
the batch, no scatter.  Inputs are padded to a fixed object count with a
validity mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e30


def splat_grid(out_h: int, out_w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer (y, x) coordinate grids, each [out_h, out_w] f32."""
    y = torch.arange(out_h, dtype=torch.float32, device=device)
    x = torch.arange(out_w, dtype=torch.float32, device=device)
    return torch.meshgrid(y, x, indexing="ij")


def _cells(center: torch.Tensor, in_h: int, in_w: int, downsample_ratio: int):
    """floor(center * in / ratio): the (y, x) cell of a normalised position."""
    return (torch.floor(center[..., 0] * in_h / downsample_ratio),
            torch.floor(center[..., 1] * in_w / downsample_ratio))


def generate_heatmap(center: torch.Tensor, label: torch.Tensor, valid: torch.Tensor,
                     n_labels: int, in_h: int, in_w: int, downsample_ratio: int,
                     sigma: float) -> torch.Tensor:
    """Per-class centre heatmaps.

    Args:
      center: [B, N, 2] normalised (y, x) object centres.
      label:  [B, N] int class labels.
      valid:  [B, N] bool.
    Returns:
      [B, n_labels, out_h, out_w] f32 heatmap in [0, 1].
    """
    out_h, out_w = int(in_h // downsample_ratio), int(in_w // downsample_ratio)
    sigma = max(float(sigma), 0.1)   # the tiny-sigma guard
    yy, xx = splat_grid(out_h, out_w, center.device)
    cy, cx = _cells(center, in_h, in_w, downsample_ratio)
    d2 = ((xx[None, None] - cx[..., None, None]) ** 2
          + (yy[None, None] - cy[..., None, None]) ** 2)          # [B, N, H, W]
    d2 = torch.where(valid[..., None, None], d2, _BIG)
    heatmaps = []
    for class_i in range(n_labels):
        class_d2 = torch.where((label == class_i)[..., None, None], d2, _BIG)
        heatmaps.append(torch.exp(-class_d2.amin(dim=1) / (2.0 * sigma ** 2)))
    return torch.stack(heatmaps, dim=1)


def generate_keypoint_heatmap(
    keypoint_center: torch.Tensor,
    keypoint_label: torch.Tensor,
    keypoint_valid: torch.Tensor,
    keypoint_object_index: torch.Tensor,
    object_center: torch.Tensor,
    n_keypoints: int,
    in_h: int,
    in_w: int,
    downsample_ratio: int,
    heatmap_sigma: float,
    affinity_sigma: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keypoint heatmaps, affinity-weight maps and affinity fields.

    The affinity field at a pixel is the unit vector from the owning
    object's centre to the pixel (normalised grid coordinates), taken from
    the keypoint instance of that channel whose owner centre is nearest.

    Args:
      keypoint_center:       [B, K, 2] normalised (y, x) positions.
      keypoint_label:        [B, K] flat keypoint channels.
      keypoint_valid:        [B, K] bool.
      keypoint_object_index: [B, K] index into the object axis.
      object_center:         [B, N, 2] normalised object centres.
    Returns:
      heatmap [B, n_keypoints, out_h, out_w], affinity_weight of the same
      shape, affinity [B, n_keypoints, 2, out_h, out_w].
    """
    out_h, out_w = int(in_h // downsample_ratio), int(in_w // downsample_ratio)
    yy, xx = splat_grid(out_h, out_w, keypoint_center.device)
    cy, cx = _cells(keypoint_center, in_h, in_w, downsample_ratio)
    d2 = ((xx[None, None] - cx[..., None, None]) ** 2
          + (yy[None, None] - cy[..., None, None]) ** 2)          # [B, K, H, W]
    d2 = torch.where(keypoint_valid[..., None, None], d2, _BIG)

    owner_center = torch.gather(
        object_center, 1, keypoint_object_index.long()[..., None].expand(-1, -1, 2))
    owner_y = owner_center[..., 0][..., None, None]              # [B, K, 1, 1]
    owner_x = owner_center[..., 1][..., None, None]
    owner_dist = torch.sqrt((yy[None, None] / out_h - owner_y) ** 2
                            + (xx[None, None] / out_w - owner_x) ** 2)
    owner_dist = torch.where(keypoint_valid[..., None, None], owner_dist, _BIG)

    heatmaps, weights, affinities = [], [], []
    for channel in range(n_keypoints):
        on_channel = (keypoint_label == channel)[..., None, None]
        min_d2 = torch.where(on_channel, d2, _BIG).amin(dim=1)
        heatmaps.append(torch.exp(-min_d2 / (2.0 * heatmap_sigma ** 2)))
        weights.append(torch.exp(-min_d2 / (2.0 * affinity_sigma ** 2)))

        chan_dist = torch.where(on_channel, owner_dist, _BIG)
        win_dist, win = chan_dist.min(dim=1)                     # first minimum, as argmin
        shape = chan_dist.shape
        win_cy = torch.gather(owner_y.expand(shape), 1, win[:, None])[:, 0]
        win_cx = torch.gather(owner_x.expand(shape), 1, win[:, None])[:, 0]
        disp_y = yy[None] / out_h - win_cy
        disp_x = xx[None] / out_w - win_cx
        any_instance = win_dist < _BIG / 2
        safe_dist = torch.clamp_min(win_dist, 1e-12)
        aff_y = torch.where(any_instance, disp_y / safe_dist, 0.0)
        aff_x = torch.where(any_instance, disp_x / safe_dist, 0.0)
        affinities.append(torch.stack((aff_y, aff_x), dim=1))

    return (torch.stack(heatmaps, dim=1), torch.stack(weights, dim=1),
            torch.stack(affinities, dim=1))


def out_index_for_position(position: torch.Tensor, in_h: int, in_w: int,
                           downsample_ratio: int) -> torch.Tensor:
    """The output grid's integer (y, x) cell of a normalised position.
    JAX's ``astype(int32)`` truncates toward zero: ``torch.trunc``."""
    out_h, out_w = int(in_h // downsample_ratio), int(in_w // downsample_ratio)
    iy = torch.clamp(torch.trunc(position[..., 0] * in_h / downsample_ratio).long(), 0, out_h - 1)
    ix = torch.clamp(torch.trunc(position[..., 1] * in_w / downsample_ratio).long(), 0, out_w - 1)
    return torch.stack((iy, ix), dim=-1)


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
