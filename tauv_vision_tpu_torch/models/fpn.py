"""Feature pyramid (counterpart of ``tauv_vision_tpu/models/fpn.py``):
1x1 laterals, bilinear top-down sum, 3x3 prediction convs + leaky-relu,
then extra stride-2 levels chained from the last prediction output.
Convs compute in ``dtype``, so in bf16 the levels are bf16, as JAX's."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, leaky_relu
from tauv_vision_tpu_torch.ops.image import resize_bilinear


class FeaturePyramid(nn.Module):
    def __init__(self, in_depths: Sequence[int], feature_depth: int,
                 n_downsample_layers: int, dtype=torch.float32):
        super().__init__()
        d = feature_depth
        self._lateral_layers = nn.ModuleList(
            Conv2d(c, d, 1, compute_dtype=dtype) for c in in_depths
        )
        self._prediction_layers = nn.ModuleList(
            Conv2d(d, d, 3, padding=1, compute_dtype=dtype) for _ in in_depths
        )
        self._downsample_layers = nn.ModuleList(
            Conv2d(d, d, 3, stride=2, padding=1, compute_dtype=dtype)
            for _ in range(n_downsample_layers)
        )

    def forward(self, backbone_outputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(x) for conv, x in zip(self._lateral_layers, backbone_outputs)]
        pyramid = list(laterals)
        for i in range(len(laterals) - 2, -1, -1):
            above = resize_bilinear(pyramid[i + 1], laterals[i].shape[-2:])
            pyramid[i] = laterals[i] + above
        outputs = [leaky_relu(conv(p)) for conv, p in zip(self._prediction_layers, pyramid)]
        for conv in self._downsample_layers:
            outputs.append(leaky_relu(conv(outputs[-1])))
        return outputs
