"""DOPE-style belief/affinity prototype cascade (counterpart of
``tauv_vision_tpu/models/pointnet.py``).

Stage 0 reads the FPN map; each later stage reads (belief, affinity, FPN
map) concatenated on the channel axis, in that order.  Within a stage the
affinity branch reads the belief the stage has just made beside the
previous stage's affinity.  A branch is a k x k conv then (count - 2)
times leaky-relu + k x k conv, then leaky-relu, a 1x1 conv to the stage's
final depth, leaky-relu and a 1x1 conv to the prototype depth.  Convs
compute in ``dtype``; the next stage reads a branch's output in that
dtype, and the stages come out cast to f32, as JAX's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, leaky_relu


class PointnetStage(nn.Module):
    """Module names ``convs.{j}`` / ``reduce`` / ``out`` are the flax
    ``conv_{j}`` / ``reduce`` / ``out``."""

    def __init__(self, in_depth: int, feature_depth: int, final_depth: int,
                 out_depth: int, kernel_size: int, layer_count: int, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.convs = nn.ModuleList(
            Conv2d(in_depth if j == 0 else feature_depth, feature_depth, k, padding=k // 2,
                   compute_dtype=dtype)
            for j in range(layer_count - 1))
        self.reduce = Conv2d(feature_depth, final_depth, 1, compute_dtype=dtype)
        self.out = Conv2d(final_depth, out_depth, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs[0](x)
        for conv in self.convs[1:]:
            x = conv(leaky_relu(x))
        x = self.reduce(leaky_relu(x))
        return self.out(leaky_relu(x))


class Pointnet(nn.Module):
    """``belief.{i}`` / ``affinity.{i}`` are the flax ``belief_{i}`` /
    ``affinity_{i}``."""

    def __init__(self, fpn_depth: int, pointnet_layers: Sequence[Tuple[int, int, int]],
                 pointnet_feature_depth: int, prototype_belief_depth: int,
                 prototype_affinity_depth: int, dtype=torch.float32):
        super().__init__()
        joined = prototype_belief_depth + prototype_affinity_depth + fpn_depth
        self.belief = nn.ModuleList()
        self.affinity = nn.ModuleList()
        for i, (kernel, count, final_depth) in enumerate(pointnet_layers):
            in_depth = fpn_depth if i == 0 else joined
            self.belief.append(PointnetStage(
                in_depth, pointnet_feature_depth, final_depth, prototype_belief_depth,
                kernel, count, dtype))
            self.affinity.append(PointnetStage(
                in_depth, pointnet_feature_depth, final_depth, prototype_affinity_depth,
                kernel, count, dtype))

    def forward(self, fpn_output: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """[B, d, h, w] -> (beliefs, affinities), each stage [B, P, h, w] f32."""
        beliefs: List[torch.Tensor] = []
        affinities: List[torch.Tensor] = []
        belief = affinity = None
        for i, (belief_stage, affinity_stage) in enumerate(zip(self.belief, self.affinity)):
            if i == 0:
                belief = belief_stage(fpn_output)
                affinity = affinity_stage(fpn_output)
            else:
                belief = belief_stage(torch.cat((belief, affinity, fpn_output), dim=1))
                affinity = affinity_stage(torch.cat((belief, affinity, fpn_output), dim=1))
            beliefs.append(belief.float())
            affinities.append(affinity.float())
        return beliefs, affinities
