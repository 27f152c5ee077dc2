"""Image preprocessing: uint8 camera frames -> resized, normalised NCHW.

Counterpart of ``tauv_vision_tpu/ops/image.py``.  The op order is the
JAX package's: resize in [0, 255] float space, then ``/ 255``, then
``- mean``, then ``/ std``.  The bilinear resizes have the semantics of
``F.interpolate`` in bilinear mode with ``align_corners=False`` and no
antialiasing, as the JAX ones, and round as ``jax.image.resize`` does on
the CPU (``_resize_as_xla``), so that a bf16 or int8 net fed the port's
image or FPN map sees the JAX package's bits.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch


@functools.lru_cache(maxsize=64)
def _triangle_weights(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] f32 bilinear weights of ``jax.image.resize`` (no
    antialiasing), in its op order: each column normalised by its sum."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    weights = torch.clamp_min(1.0 - dist, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@functools.lru_cache(maxsize=64)
def _taps(n_in: int, n_out: int, dtype, device: torch.device):
    """(k0, k1, w0, w1): the two input indices (k0 < k1) and weights of
    each output along one axis, weights cast to ``dtype`` and held as
    float64 (a bilinear weight column has at most two nonzeros; a lone
    tap gets w1 = 0), kept on ``device``.  Made outside inference mode, so
    that a training step can save them for its backward after a served
    request has filled the cache."""
    with torch.inference_mode(False):
        return _build_taps(n_in, n_out, dtype, device)


def _build_taps(n_in: int, n_out: int, dtype, device: torch.device):
    weights = _triangle_weights(n_in, n_out).to(dtype).double()
    nonzero = weights != 0
    if int(nonzero.sum(dim=0).max()) > 2:
        raise ValueError(f"more than two taps resizing {n_in} -> {n_out}")
    cols = torch.arange(n_out)
    k0 = torch.argmax(nonzero.to(torch.int8), dim=0)
    k1 = torch.clamp_max(k0 + 1, n_in - 1)
    w0 = weights[k0, cols]
    w1 = torch.where(nonzero[k1, cols] & (k1 != k0), weights[k1, cols], torch.zeros_like(w0))
    return tuple(t.to(device) for t in (k0, k1, w0, w1))


def _resize_axis(x: torch.Tensor, axis: int, n_out: int, fused: bool) -> torch.Tensor:
    """One axis of ``jax.image.resize``'s contraction in f32: products of
    f32 values are exact in float64, and the two-tap sum rounds as XLA's
    CPU dot does, w1 x1 + round(w0 x0) rounded once (a fused multiply-add,
    ``fused``) or round(w0 x0) + round(w1 x1)."""
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    k0, k1, w0, w1 = _taps(n_in, n_out, x.dtype, x.device)
    shape = [1] * x.dim()
    shape[axis] = n_out
    xd = x.double()
    p0 = w0.reshape(shape) * xd.index_select(axis, k0)
    p1 = w1.reshape(shape) * xd.index_select(axis, k1)
    if fused:
        out = (p1 + p0.float().double()).float()
    else:
        out = p0.float() + p1.float()
    return out.to(x.dtype)


def _resize_as_xla(img: torch.Tensor, axes: Tuple[int, int],
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize along ``axes`` (H, W), rounded as ``jax.image.resize``
    on the CPU rounds: weights cast to the image's dtype, one axis
    contracted at a time, each result rounded to that dtype.  XLA contracts
    first the axis its einsum path finds cheaper (fewer multiply-adds; H on
    a tie), its first dot fusing each multiply-add and its second not (as
    measured against ``jax.image.resize``, ``tests/test_torch_chain.py``).
    In bf16 both sums are of exact products and round once either way."""
    ah, aw = axes
    h, w = img.shape[ah], img.shape[aw]
    out_h, out_w = out_hw
    if h * out_w * (w + out_h) < out_h * w * (h + out_w):
        first, second = (aw, out_w), (ah, out_h)
    else:
        first, second = (ah, out_h), (aw, out_w)
    # The second axis is XLA's first dot when the first axis keeps its size.
    first_is_a_dot = img.shape[first[0]] != first[1]
    x = _resize_axis(img, *first, fused=True)
    return _resize_axis(x, *second, fused=not first_is_a_dot)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] along H and W, rounded as the JAX
    ``resize_bilinear`` (``jax.image.resize``) rounds."""
    return _resize_as_xla(img, (2, 3), out_hw)


def resize_bilinear_nhwc(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] along H and W, rounded as the JAX
    ``resize_bilinear_nhwc`` (``jax.image.resize``) rounds."""
    return _resize_as_xla(img, (1, 2), out_hw)


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of [..., H, W] by torch's legacy rule
    ``src = floor(dst * in / out)`` (not ``jax.image.resize``'s nearest),
    the scale ``in / out`` taken in f64 and the product in f32 as the JAX
    ``resize_nearest`` computes them."""
    in_h, in_w = img.shape[-2:]
    out_h, out_w = out_hw

    def source(n_out, n_in):
        scale = torch.tensor(n_in / n_out, dtype=torch.float32)
        idx = torch.floor(torch.arange(n_out, dtype=torch.float32) * scale).long()
        return torch.clamp(idx, 0, n_in - 1).to(img.device)

    return img[..., source(out_h, in_h), :][..., source(out_w, in_w)]


def normalize_image(
    img: torch.Tensor, mean: Sequence[float], stddev: Sequence[float],
    dtype=torch.float32,
) -> torch.Tensor:
    """[B, C, H, W] image in [0, 255] -> ((img / 255) - mean) / std,
    computed in f32 and rounded once to ``dtype``, as the JAX one does."""
    img = img.to(torch.float32) / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std_t = torch.tensor(stddev, dtype=torch.float32, device=img.device)
    return ((img - mean_t[:, None, None]) / std_t[:, None, None]).to(dtype)


def resize_frames(img_uint8: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 NHWC frames -> f32 contiguous NCHW resized to ``out_hw``, in
    [0, 255], rounded as the JAX pipeline's ``resize_bilinear``
    (``jax.image.resize`` on the NCHW view) rounds."""
    img = img_uint8.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    return resize_bilinear(img, out_hw).contiguous()


def preprocess(
    img_uint8: torch.Tensor,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    stddev: Sequence[float],
    dtype=torch.float32,
) -> torch.Tensor:
    """uint8 NHWC camera frames -> resized, normalised NCHW, computed in
    f32 and rounded once to ``dtype``, as the JAX ``preprocess`` does."""
    return normalize_image(resize_frames(img_uint8, out_hw), mean, stddev, dtype)
