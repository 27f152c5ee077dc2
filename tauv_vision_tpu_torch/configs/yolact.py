"""YOLACT configuration: ``YolactModelConfig``, ``YolactTrainConfig``,
``ClassConfig`` and ``ClassConfigSet`` of
``tauv_vision_tpu/configs/yolact.py``, copied so the port imports nothing
of the JAX package.  Same fields, defaults, derived properties and JSON
round trip (the files the training CLI writes beside its checkpoints)."""

from __future__ import annotations

import json
import pathlib
from dataclasses import asdict, dataclass
from typing import Optional, Tuple


class _Json:
    """``to_dict`` / ``from_dict`` / ``save`` / ``load`` of a flat config
    dataclass (tuples come back from JSON lists through ``__post_init__``)."""

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: dict):
        return cls(**data)

    def save(self, path: pathlib.Path) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_dict(), fp, indent=2)

    @classmethod
    def load(cls, path: pathlib.Path):
        with open(path) as fp:
            return cls.from_dict(json.load(fp))


@dataclass(frozen=True)
class YolactModelConfig(_Json):
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
class YolactTrainConfig(_Json):
    """Training and augmentation knobs.

    ``max_objects`` pads the truth of a batch to a fixed object count.
    ``max_positive_anchors`` caps the mask loss: with an int it runs over
    each sample's ``max_positive_anchors`` positives of highest match IoU
    and reports the positives it dropped (``YolactLosses.mask_clipped``);
    with None it runs over every positive, exactly.  ``compute_dtype`` is
    the dtype the JAX package trains the convs in."""

    lr: float
    momentum: float
    weight_decay: float
    grad_max_norm: float

    n_epochs: int
    batch_size: int
    epoch_n_batches: int

    weight_save_interval: int = 1
    gradient_save_frequency: int = 1000

    channel_shuffle_p: float = 0.0

    color_jitter_p: float = 0.0
    color_jitter_brightness: float = 0.0
    color_jitter_contrast: float = 0.0
    color_jitter_saturation: float = 0.0
    color_jitter_hue: float = 0.0

    gaussian_noise_p: float = 0.0
    gaussian_noise_var_limit: Tuple[float, float] = (0.0, 0.0)

    horizontal_flip_p: float = 0.0
    vertical_flip_p: float = 0.0

    blur_limit: Tuple[int, int] = (3, 7)
    blur_p: float = 0.0

    ssr_p: float = 0.0
    ssr_shift_limit: Tuple[float, float] = (0.0, 0.0)
    ssr_scale_limit: Tuple[float, float] = (0.0, 0.0)
    ssr_rotate_limit: Tuple[float, float] = (0.0, 0.0)

    perspective_p: float = 0.0
    perspective_scale_limit: Tuple[float, float] = (0.0, 0.0)

    min_visibility: float = 0.0

    n_workers: int = 0

    max_objects: int = 16
    max_positive_anchors: Optional[int] = 64
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        for name in ("gaussian_noise_var_limit", "blur_limit", "ssr_shift_limit",
                     "ssr_scale_limit", "ssr_rotate_limit", "perspective_scale_limit"):
            object.__setattr__(self, name, tuple(getattr(self, name)))


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

    def to_dict(self) -> dict:
        return {"configs": [asdict(c) for c in self.configs]}

    def save(self, path: pathlib.Path) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_dict(), fp, indent=2)

    @classmethod
    def load(cls, path: pathlib.Path) -> "ClassConfigSet":
        with open(path) as fp:
            data = json.load(fp)
        return cls(tuple(ClassConfig(d["id"], d["index"]) for d in data["configs"]))
