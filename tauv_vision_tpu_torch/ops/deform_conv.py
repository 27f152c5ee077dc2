"""Modulated deformable convolution v2 (DCNv2), 3x3, stride 1, padding 1.

torchvision's semantics: the sample of output pixel (y, x) at tap
k = 3 ky + kx sits at (y - 1 + ky + dy_k, x - 1 + kx + dx_k), offsets are
unbounded, each bilinear corner outside the map reads zero, and the mask
multiplies the sample.  NCHW throughout: x [B, C, H, W], offset
[B, 18, H, W] with channel 2k = dy and 2k + 1 = dx of tap k (taps
row-major), mask [B, 9, H, W] (already sigmoided) or None, weight
[O, C, 3, 3], bias [O] or None.

``deform_conv2d`` is the plain version, the gather formulation of
``tauv_vision_tpu/ops/deform_conv.deform_conv2d``; ``deform_conv2d_cuda``
wraps ``csrc/deform_conv.cu`` (kernel E), the counterpart of
``tauv_vision_tpu/ops/pallas/deform_conv.deform_conv2d_pallas`` without
its offset window.  ``DeformConv2d`` holds the weight and bias under the
reference's ``DeformConv2d`` names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from tauv_vision_tpu_torch import kernels

N_TAPS = 9
IMPLS = ("kernel", "plain")


def _check_shapes(x, offset, mask, weight, bias) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [B, C, H, W], got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (c, 3, 3):
        raise ValueError(
            f"weight must be [O, {c}, 3, 3] (stride, padding and dilation "
            f"1 only), got {tuple(weight.shape)}"
        )
    if tuple(offset.shape) != (b, 2 * N_TAPS, h, w):
        raise ValueError(
            f"offset must be [{b}, 18, {h}, {w}], got {tuple(offset.shape)}"
        )
    if mask is not None and tuple(mask.shape) != (b, N_TAPS, h, w):
        raise ValueError(f"mask must be [{b}, 9, {h}, {w}], got {tuple(mask.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias must be [{weight.shape[0]}], got {tuple(bias.shape)}")


def _bilinear_sample(flat: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                     h: int, w: int) -> torch.Tensor:
    """Sample flat [B, C, H*W] at float positions y, x [B, P] with zero
    outside the map; returns [B, C, P]."""
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    channels = flat.shape[1]

    def corner(yi, xi):
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        vals = torch.gather(flat, 2, idx[:, None, :].expand(-1, channels, -1))
        return vals * valid[:, None, :].to(flat.dtype)

    return (corner(y0, x0) * (wy0 * wx0)[:, None]
            + corner(y0, x0 + 1) * (wy0 * wx1)[:, None]
            + corner(y0 + 1, x0) * (wy1 * wx0)[:, None]
            + corner(y0 + 1, x0 + 1) * (wy1 * wx1)[:, None])


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  mask: Optional[torch.Tensor], weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: per tap, 4 corner gathers, x mask, then a GEMM with
    ``weight[:, :, ky, kx]`` accumulated in f32.  Returns [B, O, H, W]."""
    _check_shapes(x, offset, mask, weight, bias)
    b, c, h, w = x.shape
    flat = x.reshape(b, c, h * w)
    grid_y = torch.arange(h, dtype=x.dtype, device=x.device) - 1
    grid_x = torch.arange(w, dtype=x.dtype, device=x.device) - 1
    base_y = grid_y[:, None].expand(h, w).reshape(1, h * w)
    base_x = grid_x[None, :].expand(h, w).reshape(1, h * w)
    out = torch.zeros((b, weight.shape[0], h * w), dtype=torch.float32,
                      device=x.device)
    for tap in range(N_TAPS):
        ky, kx = divmod(tap, 3)
        pos_y = base_y + ky + offset[:, 2 * tap].reshape(b, h * w)
        pos_x = base_x + kx + offset[:, 2 * tap + 1].reshape(b, h * w)
        sampled = _bilinear_sample(flat, pos_y, pos_x, h, w)
        if mask is not None:
            sampled = sampled * mask[:, tap].reshape(b, 1, h * w)
        out = out + torch.einsum("bcp,oc->bop", sampled, weight[:, :, ky, kx])
    if bias is not None:
        out = out + bias[:, None]
    return out.reshape(b, -1, h, w)


def deform_conv2d_cuda(x: torch.Tensor, offset: torch.Tensor,
                       mask: Optional[torch.Tensor], weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E: ``deform_conv2d`` as one CUDA op.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  Every tensor f32, contiguous, on the current
    device."""
    _check_shapes(x, offset, mask, weight, bias)
    if x.device.type == "cpu":
        return deform_conv2d(x, offset, mask, weight, bias)
    kernels.check_cuda_tensor(x, "x", torch.float32, 4)
    kernels.check_cuda_tensor(offset, "offset", torch.float32, 4)
    kernels.check_cuda_tensor(weight, "weight", torch.float32, 4)
    if mask is not None:
        kernels.check_cuda_tensor(mask, "mask", torch.float32, 4)
    if bias is not None:
        kernels.check_cuda_tensor(bias, "bias", torch.float32, 1)
    b, c, h, w = x.shape
    o = weight.shape[0]
    out = torch.empty((b, o, h, w), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    kernels.launch(
        "tauv_deform_conv_f32", "deform_conv",
        x.data_ptr(), offset.data_ptr(),
        None if mask is None else mask.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        b, c, h, w, o,
    )
    return out


class DeformConv2d(nn.Module):
    """The deformable 3x3 conv of a DCN block: ``weight`` [O, C, 3, 3] and
    ``bias`` [O], the reference's ``DeformConv2d`` parameters.

    ``impl="kernel"`` runs ``deform_conv2d_cuda`` (kernel E on a CUDA
    tensor, the plain version on a CPU one); ``impl="plain"`` always runs
    the plain version, for comparisons on the card."""

    def __init__(self, in_channels: int, out_channels: int, impl: str = "kernel"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.normal_(self.weight, 0.0, 1.0 / math.sqrt(9 * in_channels))

    def forward(self, x, offset, mask):
        fn = deform_conv2d_cuda if self.impl == "kernel" else deform_conv2d
        return fn(x, offset, mask, self.weight, self.bias)
