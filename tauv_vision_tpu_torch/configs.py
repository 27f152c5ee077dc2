"""The served model configurations, built from ``tauv_vision_tpu.configs``.

The same configurations that ``bench.py`` serves with no flags: the
deployed CenterpointDLA34 (4 classes, heatmap/size/offset heads) and the
production YOLACT (ResNet-18, 256-wide FPN, 8 prototypes, 7 classes), both
at their native 640x360 input.
"""

from __future__ import annotations

from math import pi
from typing import Tuple

from tauv_vision_tpu.configs import (
    AngleConfig,
    CenternetModelConfig,
    ObjectConfig,
    ObjectConfigSet,
    YolactModelConfig,
)

CENTERNET_LABELS = ("sample_24_coral", "sample_24_nautilus", "torpedo_24",
                    "torpedo_24_octagon")


def centernet_config(in_h: int = 360, in_w: int = 640
                     ) -> Tuple[ObjectConfigSet, CenternetModelConfig]:
    def angle():
        return AngleConfig(train=False, modulo=2 * pi)

    object_config = ObjectConfigSet(configs=tuple(
        ObjectConfig(id=name, yaw=angle(), pitch=angle(), roll=angle(),
                     train_depth=False, train_keypoints=False, keypoints=None)
        for name in CENTERNET_LABELS
    ))
    model_config = CenternetModelConfig(
        in_h=in_h, in_w=in_w,
        backbone_heights=(2, 2, 2, 2, 2),
        backbone_channels=(128, 128, 128, 128, 128, 128),
        downsamples=2, angle_bin_overlap=pi / 3,
    )
    return object_config, model_config


def yolact_config(in_h: int = 360, in_w: int = 640,
                  feature_depth: int = 256) -> YolactModelConfig:
    return YolactModelConfig(
        in_w=in_w, in_h=in_h, feature_depth=feature_depth, n_classes=7,
        n_prototype_masks=8,
        n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
        n_prediction_head_layers=1, n_classification_layers=0,
        n_box_layers=0, n_mask_layers=0, n_fpn_downsample_layers=2,
        anchor_scales=(24, 48, 96, 192, 384), anchor_aspect_ratios=(1.0,),
        box_variances=(0.1, 0.2), iou_pos_threshold=0.4,
        iou_neg_threshold=0.3, negative_example_ratio=3,
    )
