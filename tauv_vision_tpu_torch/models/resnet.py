"""ResNet-18 feature trunk (counterpart of ``tauv_vision_tpu/models/resnet.py``).

torchvision ``resnet18`` module names.  The taps are the layer2/3/4
outputs of the last block's second BatchNorm, before the residual add
and the final ReLU (depths 128/256/512 at strides 8/16/32).  Convs compute
in ``dtype``; every BatchNorm normalises in f32 and outputs f32, as the
JAX trunk's, so the taps are f32 in any dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, batch_norm


class BasicBlock(nn.Module):
    """conv3x3-bn-relu-conv3x3-bn (+ skip) - relu; also returns the
    second BN's output before the residual add."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(planes)
        self.downsample = None
        if downsample:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, planes, 1, stride, bias=False, compute_dtype=dtype),
                batch_norm(planes),
            )

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        out = F.relu(self.bn1(self.conv1(x)))
        pre_residual = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(pre_residual + identity), pre_residual


class Resnet18Features(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(64)
        inplanes = 64
        for i, (planes, stride) in enumerate(
            ((64, 1), (128, 2), (256, 2), (512, 2)), start=1
        ):
            self.add_module(f"layer{i}", nn.Sequential(
                BasicBlock(inplanes, planes, stride, downsample=(i >= 2), dtype=dtype),
                BasicBlock(planes, planes, dtype=dtype),
            ))
            inplanes = planes

    def forward(self, img) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(img)))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for i in (1, 2, 3, 4):
            first, second = getattr(self, f"layer{i}")
            x, _ = first(x)
            x, tap = second(x)
            if i >= 2:
                taps.append(tap)
        return tuple(taps)
