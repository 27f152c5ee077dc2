"""The custom Deep Layer Aggregation backbone (counterpart of
``tauv_vision_tpu/models/dla.py``): a 7x7 stem, ``downsamples`` stride-2
residual blocks, recursive trees, then iterative deep aggregation
(``MultiIDAUp`` and ``IDAUpReverse``) back up to the finest retained
level.  Output: one [B, channels[0], H / 2^d, W / 2^d] map.

NCHW inside.  Every conv has a bias and computes in ``dtype`` (the JAX
modules' ``dtype``); every BatchNorm normalises in f32 and outputs f32,
as the JAX package's ``nn.BatchNorm(dtype=jnp.float32)``.  The IDA
upsamples are flax ``nn.ConvTranspose``s (kernel = stride, VALID), which
equal ``ConvTranspose2d`` with the kernel flipped in space; the weight
maps flip it (``weights.centernet_state_dict_from_flax``).

Module names mirror the flax tree, one port module for each flax module
(``weights.centernet_flax_path`` gives the flax path of each):
``down.stem`` is ``DLADown_0/ConvBnRelu_0``, ``down.downsample.{i}``
``ResidualBlock_{i}``, ``down.trees.{i}`` ``Tree_{i}``, ``ida_up.stages.{i}``
``MultiIDAUp_0/IDAUp_{i}``, ``ida_reverse`` ``IDAUpReverse_0``; an IDA
stage's k-th pair (``proj.{k}``, ``up.{k}``, ``node.{k}``) is its
``ConvBnRelu_{2k}``, ``ConvTranspose_{k}`` and ``ConvBnRelu_{2k+1}``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, ConvTranspose2d, batch_norm


class ConvBnRelu(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel, stride, (kernel - 1) // 2,
                           compute_dtype=dtype)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ResidualBlock(nn.Module):
    """Two 3x3 convs with a residual that is always projected (1x1 conv
    and BatchNorm, at stride 1 too): flax's ``Conv_0``/``BatchNorm_0`` is
    the projection, ``Conv_1``/``Conv_2`` the 3x3s."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.project = Conv2d(in_channels, features, 1, stride, compute_dtype=dtype)
        self.project_bn = batch_norm(features)
        self.conv1 = Conv2d(in_channels, features, 3, stride, 1, compute_dtype=dtype)
        self.bn1 = batch_norm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, compute_dtype=dtype)
        self.bn2 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = self.project_bn(self.project(x))
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + residual)


class Root(nn.Module):
    """Concatenate the children, 1x1 conv, BatchNorm, ReLU."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, features, 1, compute_dtype=dtype)
        self.bn = batch_norm(features)

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        return F.relu(self.bn(self.conv(torch.cat(children, dim=1))))


class Tree(nn.Module):
    """The recursive tree.  At height 1 two residual blocks and a root
    over ``children + [xl, xr]``; above, a subtree on x and a second one
    on its output with ``children + [xl]``.  ``n_children`` is how many
    children reach this tree from above, so the root of height 1 reads
    (n_children + 2) * features channels (the JAX tree's ``root_channels``
    is never read)."""

    def __init__(self, in_channels: int, features: int, height: int, stride: int,
                 n_children: int = 0, dtype=torch.float32):
        super().__init__()
        self.height = height
        if height == 1:
            self.block1 = ResidualBlock(in_channels, features, stride, dtype)
            self.block2 = ResidualBlock(features, features, 1, dtype)
            self.root = Root((n_children + 2) * features, features, dtype)
        else:
            self.tree1 = Tree(in_channels, features, height - 1, stride, 0, dtype)
            self.tree2 = Tree(features, features, height - 1, 1, n_children + 1, dtype)

    def forward(self, x: torch.Tensor,
                children: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        children = [] if children is None else children
        if self.height == 1:
            xl = self.block1(x)
            xr = self.block2(xl)
            return self.root(children + [xl, xr])
        xl = self.tree1(x)
        return self.tree2(xl, children + [xl])


class DLADown(nn.Module):
    """Stem, stride-2 residual blocks, then one tree a level; returns the
    stem's level and every tree's."""

    def __init__(self, heights: Sequence[int], channels: Sequence[int], downsamples: int,
                 dtype=torch.float32):
        super().__init__()
        self.stem = ConvBnRelu(3, channels[0], 7, dtype=dtype)
        self.downsample = nn.ModuleList(ResidualBlock(channels[0], channels[0], 2, dtype)
                                        for _ in range(downsamples))
        self.trees = nn.ModuleList(Tree(channels[i], channels[i + 1], h, 2, dtype=dtype)
                                   for i, h in enumerate(heights))

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(img)
        for block in self.downsample:
            x = block(x)
        outputs = [x]
        for tree in self.trees:
            x = tree(x)
            outputs.append(x)
        return outputs


def pad_to_match(feature: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """The JAX package's matcher: pad symmetrically up to the target
    (the odd row or column at the bottom or right), then keep the top-left
    target rows and columns.  (Not ``centerpoint_dla.pad_to_match``, the
    reference DLA-34's, which pads an overshoot at the top-left.)"""
    h, w = feature.shape[-2], feature.shape[-1]
    th, tw = int(target_hw[0]), int(target_hw[1])
    if (h, w) == (th, tw):
        return feature
    pad_top = max(0, (th - h) // 2)
    pad_bottom = max(0, th - h - pad_top)
    pad_left = max(0, (tw - w) // 2)
    pad_right = max(0, tw - w - pad_left)
    feature = F.pad(feature, (pad_left, pad_right, pad_top, pad_bottom))
    return feature[..., :th, :tw]


def _upsample(channels: int, scale: int, dtype) -> ConvTranspose2d:
    return ConvTranspose2d(channels, channels, scale, scale, compute_dtype=dtype)


class IDAUp(nn.Module):
    """Deepest-first aggregation: for i from the second-deepest level up,
    new[i] = node(features[i] + up(proj(new[i + 1]))), the upsample cropped
    to level i by ``pad_to_match``; returns the new levels shallowest
    first."""

    def __init__(self, feature_channels: Sequence[int], scales: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        order = list(reversed(range(len(feature_channels) - 1)))
        self.proj = nn.ModuleList(ConvBnRelu(feature_channels[i + 1], feature_channels[i],
                                             dtype=dtype) for i in order)
        self.up = nn.ModuleList(_upsample(feature_channels[i], scales[i], dtype)
                                for i in order)
        self.node = nn.ModuleList(ConvBnRelu(feature_channels[i], feature_channels[i],
                                             dtype=dtype) for i in order)

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        new_features = []
        new_feature = features[-1]
        for k, i in enumerate(reversed(range(len(features) - 1))):
            upsampled = self.up[k](self.proj[k](new_feature))
            upsampled = pad_to_match(upsampled, features[i].shape[-2:])
            new_feature = self.node[k](features[i] + upsampled)
            new_features.append(new_feature)
        return list(reversed(new_features))


class IDAUpReverse(nn.Module):
    """Shallowest-first aggregation into channels[0]:
    new = node(new + up(proj(features[i + 1]))).  With one level it
    returns that level unchanged (the JAX package's repair of the
    reference, which crashes there)."""

    def __init__(self, feature_channels: Sequence[int], scales: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        c = feature_channels[0]
        n = len(feature_channels) - 1
        self.proj = nn.ModuleList(ConvBnRelu(feature_channels[i + 1], c, dtype=dtype)
                                  for i in range(n))
        self.up = nn.ModuleList(_upsample(c, scales[i], dtype) for i in range(n))
        self.node = nn.ModuleList(ConvBnRelu(c, c, dtype=dtype) for _ in range(n))

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(features) == 1:
            return [features[0]]
        new_features = []
        new_feature = features[0]
        for i in range(len(features) - 1):
            upsampled = self.up[i](self.proj[i](features[i + 1]))
            upsampled = pad_to_match(upsampled, new_feature.shape[-2:])
            new_feature = self.node[i](new_feature + upsampled)
            new_features.append(new_feature)
        return new_features


class MultiIDAUp(nn.Module):
    """IDA stages, each over one level fewer; returns each stage's deepest
    output, shallowest first."""

    def __init__(self, feature_channels: Sequence[int], dtype=torch.float32):
        super().__init__()
        n = len(feature_channels)
        self.stages = nn.ModuleList(IDAUp(feature_channels[:n - i], [2] * (n - i - 1), dtype)
                                    for i in range(n - 1))

    def forward(self, features: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for stage in self.stages:
            features = stage(features)
            out.append(features[-1])
        return list(reversed(out))


class DLABackbone(nn.Module):
    """``DLADown``, ``MultiIDAUp`` over every level, ``IDAUpReverse`` over
    all but the deepest; [B, 3, H, W] -> [B, channels[0], H / 2^d, W / 2^d]
    in f32 (a BatchNorm's output)."""

    def __init__(self, heights: Sequence[int], channels: Sequence[int], downsamples: int,
                 dtype=torch.float32):
        super().__init__()
        n = len(channels) - 1
        self.down = DLADown(heights, channels, downsamples, dtype)
        self.ida_up = MultiIDAUp(channels, dtype)
        self.ida_reverse = IDAUpReverse(channels[:n], [2 ** i for i in range(1, n)], dtype)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.ida_reverse(self.ida_up(self.down(img)))[-1]
