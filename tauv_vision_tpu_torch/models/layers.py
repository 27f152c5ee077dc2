"""Shared model pieces: BatchNorm settings, convs that compute in a given
dtype, and seeded initialisation."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.ops.deform_conv import DeformConv2d
from tauv_vision_tpu_torch.params import cast_parameter, derived

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: the JAX package's momentum 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose output is rounded once to ``out_dtype``, as
    the JAX package's ``_bn``: the normalisation runs in f32 on any input
    and only the output is rounded.

    Training (flax's ``nn.BatchNorm(use_running_average=False)``): the
    batch mean and biased variance in f32, by flax's formulas, normalise
    the input, and the running statistics take them with momentum 0.9,
    the biased variance included (torch's own training branch would take
    the unbiased one).

    Inference: f32 in and out is ``F.batch_norm``, one pass, as the f32
    slices serve it.  Otherwise the op order is flax's, y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias in f32, so that the rounding to bf16
    falls where flax's does: three passes (the sub promotes the bf16
    input, the add writes ``out_dtype``); where autograd records, the same
    ops out of place, which round alike.  The rsqrt is correctly rounded
    (an f64 root); XLA's is within one ulp of it.  The state dict is
    ``nn.BatchNorm2d``'s."""

    def __init__(self, channels: int, out_dtype=torch.float32):
        super().__init__(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.out_dtype = out_dtype

    def _affine(self):
        """(mean, mul, bias) as [C, 1, 1] f32.  Where autograd records
        (grad enabled and the scale trainable), built in the graph of the
        scale and bias on every call; otherwise kept until a statistic or
        parameter changes."""
        def build():
            var_eps = self.running_var.float() + self.eps
            mul = (1.0 / torch.sqrt(var_eps.double())).float() * self.weight.float()
            return tuple(t.reshape(-1, 1, 1) for t in (
                self.running_mean.float(), mul, self.bias.float()))
        if torch.is_grad_enabled() and self.weight.requires_grad:
            return build()
        return derived(self, "affine", (self.running_mean, self.running_var, self.weight,
                                        self.bias), build)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        """flax's batch statistics, in the graph: mean and E[x^2] - mean^2
        (its ``use_fast_variance``, clamped at 0) in f32, and its
        normalisation (x - mean) * (rsqrt(var + eps) * scale) + bias."""
        x = x.float()
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.out_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        if x.dtype == self.out_dtype == torch.float32:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mean, mul, bias = self._affine()
        if mul.requires_grad or x.requires_grad:   # autograd records: no in-place, no out=
            return ((x - mean) * mul + bias).to(self.out_dtype)
        y = torch.sub(x, mean).mul_(mul)
        return torch.add(y, bias, out=torch.empty_like(y, dtype=self.out_dtype))


def batch_norm(channels: int, out_dtype=torch.float32) -> BatchNorm2d:
    return BatchNorm2d(channels, out_dtype)


NEGATIVE_SLOPE = 0.01


@functools.lru_cache(maxsize=None)
def _slope(dtype) -> float:
    return float(torch.tensor(NEGATIVE_SLOPE, dtype=dtype))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``leaky_relu``: where(x >= 0, x, slope x), the slope rounded
    to x's dtype first (bf16 0.010009765625, which torch's bf16
    ``F.leaky_relu`` does not round), and the gradient 1 at x == 0.  In
    f32 its values equal ``F.leaky_relu``'s, so an f32 tensor that needs no
    gradient (every served forward) takes that one pass."""
    if x.dtype == torch.float32 and not (x.requires_grad and torch.is_grad_enabled()):
        return F.leaky_relu(x, NEGATIVE_SLOPE)
    return torch.where(x >= 0, x, x * _slope(x.dtype))


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


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


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` as the JAX
    package's ``TorchConvTranspose`` does: the input and the weight cast to
    it, the bias cast and added after the transposed conv's own rounding.
    In f32 it is ``nn.ConvTranspose2d``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        if dtype == torch.float32:
            return super().forward(x.to(dtype))
        y = F.conv_transpose2d(x.to(dtype), cast_parameter(self, "weight", dtype), None,
                               self.stride, self.padding, self.output_padding, self.groups,
                               self.dilation)
        if self.bias is not None:
            y = y + cast_parameter(self, "bias", dtype)[:, None, None]
        return y


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init of every conv under ``module``.

    Conv, transposed-conv and deformable-conv weights are normal with std
    1/sqrt(fan_in) (LeCun normal), drawn from ``generator``; biases are
    zero.  BatchNorm keeps identity statistics.  Parameters that are not
    conv weights (the bilinear depthwise upsamples) keep their init.  A
    DCN block's offset conv is drawn like any other, so its offsets reach
    a few cells (kernel E samples off the grid); ``flax_init_parameters``
    is the JAX package's init, for training.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DeformConv2d)):
            w = m.weight
            w.normal_(0.0, 1.0 / math.sqrt(_fan_in(m)), generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] // m.groups * w.shape[2] * w.shape[3]
    return w.shape[1] * w.shape[2] * w.shape[3]


# flax's truncated normal: drawn in [-2, 2] standard deviations and
# rescaled by this factor so that the variance stays scale / fan_in.
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every conv under ``module`` by the JAX package's
    initialisers (equal in distribution, not in bits), flax's
    ``variance_scaling(scale, "fan_in", "truncated_normal")``:

    - conv and transposed-conv weights LeCun normal (flax's ``nn.Conv``
      default, scale 1), biases zero;
    - deformable-conv weights He normal (scale 2), biases zero;
    - the offset and mask convs of a DCN block (``zero_init``) all zero, so
      that offsets start at exactly 0 and the mask at 1/2.

    BatchNorm keeps identity statistics, the depthwise upsamples their
    bilinear kernels, and a head's bias is set by its model (the heatmap
    heads' -2.19)."""
    for m in module.modules():
        if getattr(m, "zero_init", False):
            m.weight.zero_()
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, DeformConv2d)):
            scale = 2.0 if isinstance(m, DeformConv2d) else 1.0
            std = math.sqrt(scale / _fan_in(m)) / _TRUNCATED_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


@torch.no_grad()
def xavier_init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every conv and transposed conv under ``module`` by
    flax's ``xavier_uniform`` (equal in distribution): weights uniform in
    +-sqrt(6 / (fan_in + fan_out)), fans over the kernel's taps, biases
    zero (the YOLACT's FPN, protonet and prediction head in the JAX
    package)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
