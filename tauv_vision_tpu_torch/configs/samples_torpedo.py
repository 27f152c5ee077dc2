"""The RoboSub-2024 4-class run configuration (a copy of
``tauv_vision_tpu/configs/samples_torpedo.py``): 360x640 input, batch 32,
Adam at 5e-4, focal a = 2, b = 4, sigmas 2 and the loss lambdas."""

from math import pi

from tauv_vision_tpu_torch.configs.centernet import (
    AngleConfig,
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfig,
    ObjectConfigSet,
)

model_config = CenternetModelConfig(
    in_h=360,
    in_w=640,
    backbone_heights=(2, 2, 2, 2, 2),
    backbone_channels=(128, 128, 128, 128, 128, 128),
    downsamples=2,
    angle_bin_overlap=pi / 3,
)

train_config = CenternetTrainConfig(
    lr=5e-4,
    heatmap_focal_loss_a=2,
    heatmap_focal_loss_b=4,
    heatmap_sigma_factor=0.1,
    batch_size=32,
    n_batches=0,
    n_epochs=100,
    loss_lambda_keypoint_heatmap=1.0,
    loss_lambda_keypoint_affinity=0.01,
    keypoint_heatmap_sigma=2,
    keypoint_affinity_sigma=2,
    loss_lambda_size=0.1,
    loss_lambda_offset=0.0,
    loss_lambda_angle=0.1,
    loss_lambda_depth=0.1,
    n_workers=8,
    weight_save_interval=10,
)


def _sample(id: str) -> ObjectConfig:
    return ObjectConfig(
        id=id,
        yaw=AngleConfig(train=False, modulo=2 * pi),
        pitch=AngleConfig(train=False, modulo=2 * pi),
        roll=AngleConfig(train=False, modulo=2 * pi),
        train_depth=False,
        train_keypoints=True,
        keypoints=((0, 0, 0),),
    )


object_config = ObjectConfigSet(
    configs=(
        _sample("sample_24_coral"),
        _sample("sample_24_nautilus"),
        _sample("torpedo_24"),
        _sample("torpedo_24_octagon"),
    )
)
