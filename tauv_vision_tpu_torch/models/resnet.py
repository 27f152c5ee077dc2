"""ResNet feature trunks (counterpart of ``Resnet18Features``,
``BottleneckBlock``, ``RESNET_LAYER_COUNTS`` and ``ResnetFeatures`` in
``tauv_vision_tpu/models/resnet.py``).

torchvision module names (``layerN.M.conv3``, ``downsample.0/1``).  The
taps are the layer2/3/4 outputs of each layer's last block's last
BatchNorm, before the residual add and the final ReLU: depths
128/256/512 for ResNet-18 and -34 (BasicBlocks), 512/1024/2048 for
ResNet-50 and -101 (Bottlenecks), at strides 8/16/32.  Convs compute in
``dtype``; every BatchNorm normalises in f32 and outputs f32, as the JAX
trunk's, so the taps are f32 in any dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, batch_norm

RESNET_LAYER_COUNTS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
}
PLANES = (64, 128, 256, 512)


def _downsample(inplanes: int, planes: int, stride: int, dtype) -> nn.Sequential:
    return nn.Sequential(
        Conv2d(inplanes, planes, 1, stride, bias=False, compute_dtype=dtype),
        batch_norm(planes),
    )


class BasicBlock(nn.Module):
    """conv3x3-bn-relu-conv3x3-bn (+ skip) - relu; also returns the
    second BN's output before the residual add."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(planes)
        self.downsample = _downsample(inplanes, planes, stride, dtype) if downsample else None

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        out = F.relu(self.bn1(self.conv1(x)))
        pre_residual = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(pre_residual + identity), pre_residual


class BottleneckBlock(nn.Module):
    """torchvision's Bottleneck: conv1x1-bn-relu, conv3x3(stride)-bn-relu,
    conv1x1 to 4 x planes, bn (+ skip) - relu; also returns the third BN's
    output before the residual add."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = batch_norm(out)
        self.downsample = _downsample(inplanes, out, stride, dtype) if downsample else None

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        pre_residual = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(pre_residual + identity), pre_residual


class ResnetFeatures(nn.Module):
    """The ResNet trunk of ``depth`` (a key of ``RESNET_LAYER_COUNTS``):
    the 7x7 stride-2 stem, a 3x3 stride-2 max-pool, four layers of
    BasicBlocks (18, 34) or Bottlenecks (50, 101), the first block of
    layers 2-4 at stride 2.  A layer's first block projects its identity
    where the width changes: every layer's with Bottlenecks (layer 1's too,
    64 -> 256 at stride 1), layers 2-4's with BasicBlocks."""

    def __init__(self, depth: int = 50, dtype=torch.float32):
        super().__init__()
        if depth not in RESNET_LAYER_COUNTS:
            raise ValueError(f"depth must be one of {sorted(RESNET_LAYER_COUNTS)}, got {depth}")
        block = BottleneckBlock if depth >= 50 else BasicBlock
        self.tap_depths = tuple(p * block.expansion for p in PLANES[1:])
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(64)
        inplanes = 64
        for i, (planes, count) in enumerate(zip(PLANES, RESNET_LAYER_COUNTS[depth]), start=1):
            stride = 1 if i == 1 else 2
            blocks = [block(inplanes, planes, stride,
                            downsample=(block is BottleneckBlock or i >= 2), dtype=dtype)]
            inplanes = planes * block.expansion
            blocks += [block(inplanes, planes, dtype=dtype) for _ in range(count - 1)]
            self.add_module(f"layer{i}", nn.Sequential(*blocks))

    def forward(self, img) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(img)))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for i in (1, 2, 3, 4):
            for block in getattr(self, f"layer{i}"):
                x, tap = block(x)
            if i >= 2:
                taps.append(tap.float())
        return tuple(taps)


class Resnet18Features(ResnetFeatures):
    """The YOLACT's trunk: ``ResnetFeatures(18)``."""

    def __init__(self, dtype=torch.float32):
        super().__init__(18, dtype)
