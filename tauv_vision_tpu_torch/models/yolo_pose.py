"""YOLO-Pose (counterpart of ``tauv_vision_tpu/models/yolo_pose.py``):
the YOLACT skeleton (ResNet-18 -> FPN -> protonet on level 0) plus a
Pointnet belief/affinity prototype cascade on FPN level 1 (stride 16), and
one prediction head, shared across the levels, that also emits each
anchor's belief and affinity coefficients.

Module names follow the JAX package's (``backbone``, ``fpn``,
``protonet``, ``pointnet``, ``prediction_head``), whose flax paths
``weights.yolo_pose_flax_path`` gives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
from torch import nn

from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.fpn import FeaturePyramid
from tauv_vision_tpu_torch.models.layers import (
    Conv2d,
    batch_norm,
    flax_init_parameters,
    init_parameters,
    xavier_init_parameters,
)
from tauv_vision_tpu_torch.models.pointnet import Pointnet
from tauv_vision_tpu_torch.models.prediction_head import Bottleneck, extra_stage
from tauv_vision_tpu_torch.models.protonet import Protonet
from tauv_vision_tpu_torch.models.resnet import Resnet18Features
from tauv_vision_tpu_torch.ops.anchors import get_all_anchors


@dataclass
class YoloPosePrediction:
    classification: torch.Tensor    # [B, N, C+1] logits
    box_encoding: torch.Tensor      # [B, N, 4]
    mask_coeff: torch.Tensor        # [B, N, P] (tanh'd)
    belief_coeff: torch.Tensor      # [B, N, K, Pb] (tanh'd)
    affinity_coeff: torch.Tensor    # [B, N, 2K, Pa] (tanh'd)
    anchor: torch.Tensor            # [N, 4] (y, x, h, w)
    mask_prototype: torch.Tensor    # [B, h, w, P] (NHWC view)
    belief_prototypes: Tuple[torch.Tensor, ...]    # stages of [B, hb, wb, Pb] (NHWC views)
    affinity_prototypes: Tuple[torch.Tensor, ...]  # stages of [B, hb, wb, Pa] (NHWC views)


class ExtraStage(nn.Module):
    """The JAX package's ``ExtraStage``, relu(conv1x1(x) + bn(bottleneck(x))),
    under its flax names (``bottleneck``, ``conv``, ``bn``)."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.bottleneck = Bottleneck(features, dtype)
        self.conv = Conv2d(features, features, 1, compute_dtype=dtype)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return extra_stage(x, self.bottleneck, self.conv, self.bn)


HEAD_OUTPUTS = ("classification", "box", "mask", "belief", "affinity")


class YoloPoseHead(nn.Module):
    """Shared extra stages, then 3x3 output convs for the class logits, box
    encodings and the mask, belief and affinity coefficients (tanh'd in
    the convs' dtype).  Each output is flattened from NHWC, cell-major
    ``[B, h*w*A, ...]`` like the anchors, the belief and affinity channels
    split keypoint-major as ``[K, Pb]``; all come out f32."""

    def __init__(self, cfg: YoloPoseModelConfig, dtype=torch.float32):
        super().__init__()
        d, a = cfg.feature_depth, cfg.n_anchors_per_cell
        self.shared = nn.ModuleList(ExtraStage(d, dtype)
                                    for _ in range(cfg.n_prediction_head_layers))
        self.shapes = {
            "classification": (cfg.n_classes + 1,),
            "box": (4,),
            "mask": (cfg.n_prototype_masks,),
            "belief": (cfg.belief_depth, cfg.prototype_belief_depth),
            "affinity": (cfg.affinity_depth, cfg.prototype_affinity_depth),
        }
        for name in HEAD_OUTPUTS:
            n = a * math.prod(self.shapes[name])
            setattr(self, name, Conv2d(d, n, 3, padding=1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """[B, d, h, w] -> the five outputs, in ``HEAD_OUTPUTS`` order."""
        b = x.shape[0]
        for stage in self.shared:
            x = stage(x)
        outs = []
        for name in HEAD_OUTPUTS:
            # NCHW -> NHWC before the reshape: JAX's [B, h, w, A*C] order.
            y = getattr(self, name)(x).permute(0, 2, 3, 1).reshape(b, -1, *self.shapes[name])
            if name in ("mask", "belief", "affinity"):
                y = torch.tanh(y)
            outs.append(y.float())
        return tuple(outs)


def _flax_init(model: "YoloPose", generator: torch.Generator) -> None:
    """The JAX package's initialisers: the ResNet's, the Pointnet's and the
    head's output convs LeCun normal (flax's ``nn.Conv`` default), the
    FPN's, protonet's and the head's extra stages xavier-uniform, biases
    zero."""
    flax_init_parameters(model.backbone, generator)
    xavier_init_parameters(model.fpn, generator)
    xavier_init_parameters(model.protonet, generator)
    flax_init_parameters(model.pointnet, generator)
    xavier_init_parameters(model.prediction_head.shared, generator)
    for name in HEAD_OUTPUTS:
        flax_init_parameters(getattr(model.prediction_head, name), generator)


INITS = {"lecun": init_parameters, "flax": _flax_init}


class YoloPose(nn.Module):
    """Weights are drawn from ``generator`` (the torch default generator
    when None): ``init="lecun"`` draws every conv LeCun normal,
    ``init="flax"`` by the JAX package's initialisers.  Every conv
    computes in ``dtype`` (the JAX ``YoloPose(dtype=)``); BatchNorms
    normalise in f32 and output f32, and every output is f32.  The module
    is moved to ``device`` (the card unless the caller passes "cpu"); call
    ``.eval()`` to serve."""

    def __init__(self, config: YoloPoseModelConfig,
                 generator: Optional[torch.Generator] = None,
                 device=DEFAULT_DEVICE, dtype=torch.float32, init: str = "lecun"):
        super().__init__()
        if init not in INITS:
            raise ValueError(f"init must be one of {sorted(INITS)}, got {init!r}")
        device = resolve_device(device)
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.backbone = Resnet18Features(dtype)
        self.fpn = FeaturePyramid((128, 256, 512), cfg.feature_depth,
                                  cfg.n_fpn_downsample_layers, dtype)
        self.protonet = Protonet(cfg.feature_depth, cfg.n_prototype_masks,
                                 cfg.n_masknet_layers_pre_upsample,
                                 cfg.n_masknet_layers_post_upsample, dtype)
        self.pointnet = Pointnet(cfg.feature_depth, cfg.pointnet_layers,
                                 cfg.pointnet_feature_depth, cfg.prototype_belief_depth,
                                 cfg.prototype_affinity_depth, dtype)
        self.prediction_head = YoloPoseHead(cfg, dtype)
        anchor = get_all_anchors(cfg.in_h, cfg.in_w, cfg.n_fpn_levels,
                                 cfg.anchor_scales, cfg.anchor_aspect_ratios)
        self.register_buffer("anchor", torch.from_numpy(anchor), persistent=False)
        if generator is None:
            generator = torch.default_generator
        INITS[init](self, generator)
        self.to(device)

    def forward(self, img: torch.Tensor) -> YoloPosePrediction:
        """img: [B, 3, H, W], f32 or rounded to bf16; the stem casts it to
        ``dtype``."""
        fpn_outputs = self.fpn(self.backbone(img))
        prototype = self.protonet(fpn_outputs[0])
        beliefs, affinities = self.pointnet(fpn_outputs[1])
        heads: List[Tuple[torch.Tensor, ...]] = [self.prediction_head(x) for x in fpn_outputs]
        classification, box, mask, belief, affinity = (torch.cat(t, dim=1) for t in zip(*heads))

        def nhwc(maps):
            return tuple(t.permute(0, 2, 3, 1) for t in maps)

        return YoloPosePrediction(
            classification=classification,
            box_encoding=box,
            mask_coeff=mask,
            belief_coeff=belief,
            affinity_coeff=affinity,
            anchor=self.anchor,
            mask_prototype=prototype.permute(0, 2, 3, 1),
            belief_prototypes=nhwc(beliefs),
            affinity_prototypes=nhwc(affinities),
        )
