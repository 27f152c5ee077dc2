"""YOLO-Pose configuration: ``YoloPoseModelConfig`` of
``tauv_vision_tpu/configs/yolo_pose.py``, copied so the port imports
nothing of the JAX package.  Same fields, defaults, derived properties
and JSON round trip.  ``backbone_depth`` is the ResNet trunk's depth,
one of ``BACKBONE_DEPTHS``; another raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from tauv_vision_tpu_torch.configs.yolact import _Json

BACKBONE_DEPTHS = (18, 34, 50, 101)


@dataclass(frozen=True)
class YoloPoseModelConfig(_Json):
    in_w: int
    in_h: int

    feature_depth: int

    n_classes: int
    n_prototype_masks: int

    n_masknet_layers_pre_upsample: int
    n_masknet_layers_post_upsample: int

    # Each stage: (kernel_size, layer_count, stage_final_depth).
    pointnet_layers: Tuple[Tuple[int, int, int], ...]
    pointnet_feature_depth: int
    prototype_belief_depth: int
    prototype_affinity_depth: int
    belief_depth: int      # keypoints per object
    affinity_depth: int    # 2 * belief_depth

    n_prediction_head_layers: int
    n_fpn_downsample_layers: int

    belief_sigma: float
    affinity_radius: float

    anchor_scales: Tuple[float, ...]
    anchor_aspect_ratios: Tuple[float, ...]

    box_variances: Tuple[float, float]

    iou_pos_threshold: float
    iou_neg_threshold: float

    negative_example_ratio: int

    img_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    img_stddev: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    backbone_depth: int = 18

    def __post_init__(self):
        if self.backbone_depth not in BACKBONE_DEPTHS:
            raise ValueError(
                f"backbone_depth must be one of {BACKBONE_DEPTHS}, got {self.backbone_depth}")
        object.__setattr__(
            self, "pointnet_layers",
            tuple(tuple(layer) for layer in self.pointnet_layers),
        )
        for name in ("anchor_scales", "anchor_aspect_ratios", "box_variances",
                     "img_mean", "img_stddev"):
            object.__setattr__(self, name, tuple(getattr(self, name)))

    @property
    def n_anchors_per_cell(self) -> int:
        return len(self.anchor_aspect_ratios)

    @property
    def n_fpn_levels(self) -> int:
        return 3 + self.n_fpn_downsample_layers
