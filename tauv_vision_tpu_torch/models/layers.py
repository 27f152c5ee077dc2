"""Shared model pieces: BatchNorm settings and seeded initialisation."""

from __future__ import annotations

import math

import torch
from torch import nn

from tauv_vision_tpu_torch.ops.deform_conv import DeformConv2d

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; the JAX package's 0.9


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


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
