"""Shared model pieces: BatchNorm settings, convs that compute in a given
dtype, and seeded initialisation."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.ops.deform_conv import DeformConv2d
from tauv_vision_tpu_torch.params import cast_parameter, derived

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; the JAX package's 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose inference output is rounded once to
    ``out_dtype``, as the JAX package's ``_bn``: the normalisation runs in
    f32 on any input and only the output is rounded.

    f32 in and out is ``F.batch_norm``, one pass, as the f32 slices serve
    it.  Otherwise the op order is flax's, y = (x - mean) * (rsqrt(var +
    eps) * scale) + bias in f32, so that the rounding to bf16 falls where
    flax's does: three passes (the sub promotes the bf16 input, the add
    writes ``out_dtype``).  The rsqrt is correctly rounded (an f64 root);
    XLA's is within one ulp of it.  The state dict is
    ``nn.BatchNorm2d``'s."""

    def __init__(self, channels: int, out_dtype=torch.float32):
        super().__init__(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.out_dtype = out_dtype

    def _affine(self):
        """(mean, mul, bias) as [C, 1, 1] f32, kept until a statistic or
        parameter changes."""
        def build():
            var_eps = self.running_var.float() + self.eps
            mul = (1.0 / torch.sqrt(var_eps.double())).float() * self.weight.float()
            return tuple(t.reshape(-1, 1, 1) for t in (
                self.running_mean.float(), mul, self.bias.detach().float()))
        return derived(self, "affine", (self.running_mean, self.running_var, self.weight,
                                        self.bias), build)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x).to(self.out_dtype)
        if x.dtype == self.out_dtype == torch.float32:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mean, mul, bias = self._affine()
        y = torch.sub(x, mean).mul_(mul)
        return torch.add(y, bias, out=torch.empty_like(y, dtype=self.out_dtype))


def batch_norm(channels: int, out_dtype=torch.float32) -> BatchNorm2d:
    return BatchNorm2d(channels, out_dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` as flax's
    ``nn.Conv(dtype=...)`` does: the input, the weight and the bias are
    cast to it, and the bias is added after the convolution's own
    rounding.  In f32 it is ``nn.Conv2d``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype == torch.float32:
            return super().forward(x.to(dtype))
        y = F.conv2d(x.to(dtype), cast_parameter(self, "weight", dtype), None,
                     self.stride, self.padding, self.dilation, self.groups)
        if self.bias is not None:
            y = y + cast_parameter(self, "bias", dtype)[:, None, None]
        return y


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init of every conv under ``module``.

    Conv, transposed-conv and deformable-conv weights are normal with std
    1/sqrt(fan_in) (LeCun normal), drawn from ``generator``; biases are
    zero.  BatchNorm keeps identity statistics.  Parameters that are not
    conv weights (the bilinear depthwise upsamples) keep their init.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DeformConv2d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] // m.groups * w.shape[2] * w.shape[3]
            else:
                fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
