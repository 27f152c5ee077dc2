"""Image preprocessing: uint8 camera frames -> resized, normalised NCHW.

Counterpart of ``tauv_vision_tpu/ops/image.py``.  The op order is the
JAX package's: resize in [0, 255] float space, then ``/ 255``, then
``- mean``, then ``/ std``.  ``resize_bilinear`` is ``F.interpolate`` in
bilinear mode with ``align_corners=False`` and no antialiasing, the
semantics the JAX ``resize_bilinear`` reproduces.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] along H and W."""
    return F.interpolate(
        img, size=tuple(out_hw), mode="bilinear", align_corners=False,
        antialias=False,
    )


def normalize_image(
    img: torch.Tensor, mean: Sequence[float], stddev: Sequence[float],
) -> torch.Tensor:
    """[B, C, H, W] image in [0, 255] -> ((img / 255) - mean) / std, f32."""
    img = img.to(torch.float32) / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.tensor(stddev, dtype=torch.float32, device=img.device)
    return (img - mean_t[:, None, None]) / std_t[:, None, None]


def resize_frames(img_uint8: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 NHWC frames -> f32 contiguous NCHW resized to ``out_hw``, in
    [0, 255].  (Resizing the permuted view would hand back channels-last
    strides, which the nets would then carry through every conv.)"""
    img = img_uint8.to(torch.float32).permute(0, 3, 1, 2)
    return resize_bilinear(img, out_hw).contiguous()


def preprocess(
    img_uint8: torch.Tensor,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    stddev: Sequence[float],
) -> torch.Tensor:
    """uint8 NHWC camera frames -> resized, normalised f32 NCHW."""
    return normalize_image(resize_frames(img_uint8, out_hw), mean, stddev)
