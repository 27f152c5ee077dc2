"""Image preprocessing: uint8 camera frames -> resized, normalised NCHW.

Counterpart of ``tauv_vision_tpu/ops/image.py``.  The op order is the
JAX package's: resize in [0, 255] float space, then ``/ 255``, then
``- mean``, then ``/ std``.  ``resize_bilinear`` is ``F.interpolate`` in
bilinear mode with ``align_corners=False`` and no antialiasing, the
semantics the JAX ``resize_bilinear`` reproduces.  ``resize_bilinear_nhwc``,
the int8 chain's FPN resize, also rounds as the JAX one does, so that a
bf16 chain's codes match.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] along H and W."""
    return F.interpolate(
        img, size=tuple(out_hw), mode="bilinear", align_corners=False,
        antialias=False,
    )


@functools.lru_cache(maxsize=64)
def _triangle_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """[n_in, n_out] f32 bilinear weights of ``jax.image.resize`` (no
    antialiasing), in its op order: each column normalised by its sum.
    Computed on the CPU, kept on ``device``."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    weights = torch.clamp_min(1.0 - dist, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_bilinear_nhwc(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] along H and W, rounded as the JAX
    ``resize_bilinear_nhwc`` (``jax.image.resize``) rounds: weights cast to
    the image's dtype, one axis contracted at a time, each result rounded
    to that dtype.  XLA contracts first the axis its einsum path finds
    cheaper (fewer multiply-adds; H on a tie).  The products of bf16
    values are exact in f32, so the f32 contraction rounds only where
    XLA's does."""
    _, h, w, _ = img.shape
    out_h, out_w = out_hw
    dtype = img.dtype

    def along(x, axis, n_in, n_out):
        if n_in == n_out:
            return x
        weights = _triangle_weights(n_in, n_out, x.device).to(dtype).float()
        spec = "bhwc,hH->bHwc" if axis == "h" else "bhwc,wW->bhWc"
        return torch.einsum(spec, x.to(torch.float32), weights).to(dtype)

    if h * out_w * (w + out_h) < out_h * w * (h + out_w):
        return along(along(img, "w", w, out_w), "h", h, out_h)
    return along(along(img, "h", h, out_h), "w", w, out_w)


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
