"""YOLACT anchors (counterpart of ``tauv_vision_tpu/ops/anchors.py``).

Anchors depend only on the config, so they are computed once with numpy.
They are cell-major (y, x, aspect ratio), the order of the prediction
head's NHWC flatten, so slot i of every head output pairs with anchor i.
"""

from __future__ import annotations

from math import sqrt
from typing import Sequence, Tuple

import numpy as np


def fpn_level_sizes(
    in_h: int, in_w: int, n_levels: int
) -> Tuple[Tuple[int, int], ...]:
    """Feature-map sizes of each FPN level: strides 8/16/32, then extra
    stride-2 levels with ceil rounding."""
    sizes = [(-(-in_h // s), -(-in_w // s)) for s in (8, 16, 32)]
    h, w = sizes[-1]
    for _ in range(n_levels - 3):
        h = (h - 1) // 2 + 1
        w = (w - 1) // 2 + 1
        sizes.append((h, w))
    return tuple(sizes)


def _level_anchors(
    fpn_i: int, fpn_size: Tuple[int, int], anchor_scales: Sequence[float],
    anchor_aspect_ratios: Sequence[float], in_h: int, in_w: int,
) -> np.ndarray:
    fh, fw = fpn_size
    y = (np.arange(fh, dtype=np.float32) + 0.5) / fh
    x = (np.arange(fw, dtype=np.float32) + 0.5) / fw
    yy, xx = np.meshgrid(y, x, indexing="ij")
    in_size = (in_h + in_w) / 2
    scale = anchor_scales[fpn_i]
    hs = np.array([(scale / in_size) * sqrt(ar) for ar in anchor_aspect_ratios],
                  dtype=np.float32)
    ws = np.array([(scale / in_size) / sqrt(ar) for ar in anchor_aspect_ratios],
                  dtype=np.float32)
    n_ar = len(anchor_aspect_ratios)
    yy = np.broadcast_to(yy[:, :, None], (fh, fw, n_ar))
    xx = np.broadcast_to(xx[:, :, None], (fh, fw, n_ar))
    hh = np.broadcast_to(hs[None, None, :], (fh, fw, n_ar))
    ww = np.broadcast_to(ws[None, None, :], (fh, fw, n_ar))
    return np.stack((yy, xx, hh, ww), axis=-1).reshape(-1, 4).astype(np.float32)


def get_all_anchors(
    in_h: int, in_w: int, n_fpn_levels: int,
    anchor_scales: Sequence[float], anchor_aspect_ratios: Sequence[float],
) -> np.ndarray:
    """All levels concatenated: [sum_l fh_l * fw_l * A, 4] f32 (y, x, h, w)."""
    sizes = fpn_level_sizes(in_h, in_w, n_fpn_levels)
    return np.concatenate([
        _level_anchors(i, sizes[i], anchor_scales, anchor_aspect_ratios,
                       in_h, in_w)
        for i in range(n_fpn_levels)
    ], axis=0)
