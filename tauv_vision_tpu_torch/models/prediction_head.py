"""YOLACT shared prediction head (counterpart of
``tauv_vision_tpu/models/prediction_head.py``).

Optional extra stages ``relu(conv1x1(x) + bn(bottleneck(x)))`` for the
shared trunk and the class/box/mask branches, then 3x3 output convs.
Outputs are flattened from NHWC, so they are cell-major
``[B, H*W*A, .]`` like the anchors.  The reference torch names keep each
extra stage's three parts in separate lists (``_extra_layers``,
``_extra_conv_layers``, ``_extra_bn_layers``, and the same for the
``_classification_extra`` / ``_box_extra`` / ``_mask_extra`` branches).
Convs compute in ``dtype``, BatchNorms output f32 (so an extra stage's
output is f32), the mask coefficients' tanh runs in the conv's dtype, and
the outputs are f32, as the JAX head's.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, batch_norm


class Bottleneck(nn.Module):
    """torchvision Bottleneck(inplanes=d, planes=d//4), identity skip."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        planes = features // 4
        self.conv1 = Conv2d(features, planes, 1, bias=False, compute_dtype=dtype)
        self.bn1 = batch_norm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, compute_dtype=dtype)
        self.bn2 = batch_norm(planes)
        self.conv3 = Conv2d(planes, features, 1, bias=False, compute_dtype=dtype)
        self.bn3 = batch_norm(features)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + x)


def extra_stage(x: torch.Tensor, bottleneck: nn.Module, conv: nn.Module,
                bn: nn.Module) -> torch.Tensor:
    """The JAX package's ExtraStage: relu(conv1x1(x) + bn(bottleneck(x)))."""
    return F.relu(conv(x) + bn(bottleneck(x)))


_GROUPS = ("_extra", "_classification_extra", "_box_extra", "_mask_extra")


class PredictionHead(nn.Module):
    def __init__(self, feature_depth: int, n_classes: int, n_prototype_masks: int,
                 n_anchors: int, n_prediction_head_layers: int = 1,
                 n_classification_layers: int = 0, n_box_layers: int = 0,
                 n_mask_layers: int = 0, dtype=torch.float32):
        super().__init__()
        d = feature_depth
        self.n_classes = n_classes
        self.n_prototype_masks = n_prototype_masks
        counts = (n_prediction_head_layers, n_classification_layers,
                  n_box_layers, n_mask_layers)
        for group, count in zip(_GROUPS, counts):
            setattr(self, f"{group}_layers",
                    nn.ModuleList(Bottleneck(d, dtype) for _ in range(count)))
            setattr(self, f"{group}_conv_layers",
                    nn.ModuleList(Conv2d(d, d, 1, compute_dtype=dtype) for _ in range(count)))
            setattr(self, f"{group}_bn_layers",
                    nn.ModuleList(batch_norm(d) for _ in range(count)))
        self._classification_layer = Conv2d(d, n_anchors * (n_classes + 1), 3, padding=1,
                                            compute_dtype=dtype)
        self._box_encoding_layer = Conv2d(d, n_anchors * 4, 3, padding=1, compute_dtype=dtype)
        self._mask_coeff_layer = Conv2d(d, n_anchors * n_prototype_masks, 3, padding=1,
                                        compute_dtype=dtype)

    def _stages(self, group: str, x: torch.Tensor) -> torch.Tensor:
        for parts in zip(getattr(self, f"{group}_layers"),
                         getattr(self, f"{group}_conv_layers"),
                         getattr(self, f"{group}_bn_layers")):
            x = extra_stage(x, *parts)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[B, d, h, w] -> classification [B, h*w*A, C+1], box [B, h*w*A, 4],
        tanh'd mask coefficients [B, h*w*A, P], all f32."""
        b = x.shape[0]
        x = self._stages("_extra", x)

        def flat(t, n):
            return t.permute(0, 2, 3, 1).reshape(b, -1, n)

        classification = flat(self._classification_layer(
            self._stages("_classification_extra", x)), self.n_classes + 1)
        box = flat(self._box_encoding_layer(self._stages("_box_extra", x)), 4)
        coeff = torch.tanh(flat(self._mask_coeff_layer(
            self._stages("_mask_extra", x)), self.n_prototype_masks))
        return classification.float(), box.float(), coeff.float()
