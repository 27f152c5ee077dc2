"""YOLACT (counterpart of ``tauv_vision_tpu/models/yolact.py``).

ResNet-18 -> FPN (3 taps + extra levels) -> protonet on level 0 and one
shared prediction head over every level, outputs concatenated over the
anchor axis.  Module names follow the reference torch layout that
``tauv_vision_tpu.models.yolact.export_yolact_state_dict`` writes
(``_backbone``, ``_feature_pyramid``, ``_masknet``, ``_prediction_head``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.fpn import FeaturePyramid
from tauv_vision_tpu_torch.models.layers import init_parameters
from tauv_vision_tpu_torch.models.prediction_head import PredictionHead
from tauv_vision_tpu_torch.models.protonet import Protonet
from tauv_vision_tpu_torch.models.resnet import Resnet18Features
from tauv_vision_tpu_torch.ops.anchors import get_all_anchors


@dataclass
class YolactPrediction:
    classification: torch.Tensor   # [B, N, C+1] logits
    box_encoding: torch.Tensor     # [B, N, 4]
    mask_coeff: torch.Tensor       # [B, N, P] (tanh'd)
    anchor: torch.Tensor           # [N, 4] (y, x, h, w)
    mask_prototype: torch.Tensor   # [B, proto_h, proto_w, P] (NHWC view)


class Yolact(nn.Module):
    """Weights are drawn from ``generator`` (the torch default generator
    when None) and the module is moved to ``device`` (the card unless the
    caller passes "cpu"); call ``.eval()`` to serve."""

    def __init__(self, config: YolactModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self._backbone = Resnet18Features()
        self._feature_pyramid = FeaturePyramid(
            (128, 256, 512), cfg.feature_depth, cfg.n_fpn_downsample_layers,
        )
        self._masknet = Protonet(
            cfg.feature_depth, cfg.n_prototype_masks,
            cfg.n_masknet_layers_pre_upsample,
            cfg.n_masknet_layers_post_upsample,
        )
        self._prediction_head = PredictionHead(
            cfg.feature_depth, cfg.n_classes, cfg.n_prototype_masks,
            cfg.n_anchors_per_cell, cfg.n_prediction_head_layers,
            cfg.n_classification_layers, cfg.n_box_layers, cfg.n_mask_layers,
        )
        anchor = get_all_anchors(cfg.in_h, cfg.in_w, cfg.n_fpn_levels,
                                 cfg.anchor_scales, cfg.anchor_aspect_ratios)
        self.register_buffer("anchor", torch.from_numpy(anchor), persistent=False)
        if generator is None:
            generator = torch.default_generator
        init_parameters(self, generator)
        self.to(device)

    def forward(self, img: torch.Tensor) -> YolactPrediction:
        """img: [B, 3, H, W] normalised, f32 or rounded to bf16 (computed
        in f32 either way, as flax promotes a bf16 image in an f32 conv)."""
        fpn_outputs = self._feature_pyramid(self._backbone(img.to(torch.float32)))
        prototype = self._masknet(fpn_outputs[0])
        heads = [self._prediction_head(x) for x in fpn_outputs]
        classification, box, coeff = (torch.cat(t, dim=1) for t in zip(*heads))
        return YolactPrediction(
            classification=classification,
            box_encoding=box,
            mask_coeff=coeff,
            anchor=self.anchor,
            mask_prototype=prototype.permute(0, 2, 3, 1),
        )
