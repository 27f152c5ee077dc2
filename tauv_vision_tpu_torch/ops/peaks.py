"""Heatmap peak extraction, the CenterNet decode front end.

Counterpart of ``tauv_vision_tpu/ops/peaks.py`` (plain version) and of
``tauv_vision_tpu/ops/pallas/peak_decode.py`` (``peak_decode_cuda``, the
wrapper of ``csrc/peak_decode.cu``).

Ties: ``jax.lax.top_k`` returns equal values in ascending index order,
and equal values are real here (sigmoid saturates to exactly 1.0 in f32
for logits above about 17, and a plateau survives the 3x3 equality NMS
whole).  ``torch.topk`` leaves the order of ties unspecified, so the
plain version takes a stable descending sort and slices it; the kernel
pins the same rule.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tauv_vision_tpu_torch import kernels

MAX_DETECTIONS = 128
MAX_KERNEL_SIZE = 31   # kernel A stages a tile's halo of (k - 1) / 2 cells
TILE_ROWS = 16         # kernel A's tile: 16 rows x at most 256 columns
TILE_COLS = 256


def peak_tiles(c: int, h: int, w: int) -> Tuple[int, int, int]:
    """Kernel A's tiling of a [C, H, W] map: (tile rows, tile columns,
    tiles), a tile per channel, band of ``TILE_ROWS`` rows and run of at
    most ``TILE_COLS`` columns (the whole row where it fits)."""
    tile_w = min(w, TILE_COLS)
    return TILE_ROWS, tile_w, c * -(-h // TILE_ROWS) * -(-w // tile_w)


def heatmap_nms(heatmap: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Keep values equal to their kxk max (out-of-range cells ignored).

    heatmap: [B, C, H, W] probabilities.  Returns the same shape."""
    assert kernel_size >= 1 and kernel_size % 2 == 1
    pad = (kernel_size - 1) // 2
    local_max = F.max_pool2d(heatmap, kernel_size, stride=1, padding=pad)
    return torch.where(local_max == heatmap, heatmap, torch.zeros_like(heatmap))


def heatmap_detect(
    heatmap: torch.Tensor, n_detections: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k peaks over all channels of a suppressed [B, C, H, W] heatmap.

    Returns index [B, K, 2] int32 (y, x), label [B, K] int32 and score
    [B, K]; ties in ascending flat-index order."""
    b, c, h, w = heatmap.shape
    flat = heatmap.reshape(b, c * h * w)
    score, flat_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    score = score[:, :n_detections]
    flat_idx = flat_idx[:, :n_detections]
    label = torch.div(flat_idx, h * w, rounding_mode="floor").to(torch.int32)
    cell = (flat_idx % (h * w)).to(torch.int32)
    index = torch.stack(
        (torch.div(cell, w, rounding_mode="floor"), cell % w), dim=-1
    ).to(torch.int32)
    return index, label, score


def peak_decode(
    heatmap_logits: torch.Tensor, n_detections: int, kernel_size: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain sigmoid -> NMS -> top-k."""
    heatmap = torch.sigmoid(heatmap_logits)
    return heatmap_detect(heatmap_nms(heatmap, kernel_size), n_detections)


def peak_decode_cuda(
    heatmap_logits: torch.Tensor, n_detections: int, kernel_size: int = 3
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel A: ``peak_decode`` as CUDA ops (a top-K a tile, then a
    merge an image; see ``csrc/peak_decode.cu``).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  heatmap_logits: [B, C, H, W] f32."""
    b, c, h, w = heatmap_logits.shape
    if not 1 <= n_detections <= min(MAX_DETECTIONS, c * h * w):
        raise ValueError(
            f"n_detections must be in [1, min({MAX_DETECTIONS}, C*H*W)], "
            f"got {n_detections}"
        )
    if kernel_size < 1 or kernel_size % 2 == 0:
        raise ValueError(f"kernel_size must be odd, got {kernel_size}")
    if heatmap_logits.device.type == "cpu":
        return peak_decode(heatmap_logits, n_detections, kernel_size)
    if kernel_size > MAX_KERNEL_SIZE:
        raise ValueError(f"kernel_size at most {MAX_KERNEL_SIZE} on the card, "
                         f"got {kernel_size}")
    kernels.check_cuda_tensor(heatmap_logits, "heatmap_logits", torch.float32, 4)
    dev = heatmap_logits.device
    tile_h, tile_w, tiles = peak_tiles(c, h, w)
    # Each tile's best K as 64-bit keys; the suppressed map is never stored.
    candidates = torch.empty((b, tiles, n_detections), dtype=torch.int64, device=dev)
    index = torch.empty((b, n_detections, 2), dtype=torch.int32, device=dev)
    label = torch.empty((b, n_detections), dtype=torch.int32, device=dev)
    score = torch.empty((b, n_detections), dtype=torch.float32, device=dev)
    kernels.launch(
        "tauv_peak_decode_f32", "peak_decode",
        heatmap_logits.data_ptr(), candidates.data_ptr(), index.data_ptr(),
        label.data_ptr(), score.data_ptr(), b, c, h, w, n_detections,
        kernel_size, tile_h, tile_w, variant=f"K={n_detections}",
    )
    return index, label, score
