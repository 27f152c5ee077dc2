"""YOLACT configuration: ``YolactModelConfig``, ``ClassConfig`` and
``ClassConfigSet`` of ``tauv_vision_tpu/configs/yolact.py``, copied so the
port imports nothing of the JAX package.  Same fields, defaults and
derived properties; the JSON round trip of the original is not copied."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class YolactModelConfig:
    """Architecture knobs."""

    in_w: int
    in_h: int

    feature_depth: int

    n_classes: int
    n_prototype_masks: int

    n_masknet_layers_pre_upsample: int
    n_masknet_layers_post_upsample: int

    n_prediction_head_layers: int
    n_classification_layers: int
    n_box_layers: int
    n_mask_layers: int

    n_fpn_downsample_layers: int

    anchor_scales: Tuple[float, ...]
    anchor_aspect_ratios: Tuple[float, ...]

    box_variances: Tuple[float, float]

    iou_pos_threshold: float
    iou_neg_threshold: float

    negative_example_ratio: int

    img_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    img_stddev: Tuple[float, float, float] = (0.229, 0.224, 0.225)

    def __post_init__(self):
        for name in ("anchor_scales", "anchor_aspect_ratios", "box_variances",
                     "img_mean", "img_stddev"):
            object.__setattr__(self, name, tuple(getattr(self, name)))

    @property
    def n_anchors_per_cell(self) -> int:
        return len(self.anchor_aspect_ratios)

    @property
    def n_fpn_levels(self) -> int:
        # 3 backbone taps + extra stride-2 levels.
        return 3 + self.n_fpn_downsample_layers


@dataclass(frozen=True)
class ClassConfig:
    """id / index pair; index 0 is the background, so classes start at 1."""

    id: str
    index: int


@dataclass(frozen=True)
class ClassConfigSet:
    configs: Tuple[ClassConfig, ...]

    def __post_init__(self):
        object.__setattr__(self, "configs", tuple(self.configs))

    def get_by_index(self, index: int) -> Optional[ClassConfig]:
        for config in self.configs:
            if config.index == index:
                return config
        return None

    def get_by_id(self, id: str) -> Optional[ClassConfig]:
        for config in self.configs:
            if config.id == id:
                return config
        return None
