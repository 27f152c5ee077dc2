"""YOLACT training entry point (counterpart of
``tauv_vision_tpu/scripts/train_yolact.py``, with the same flags and
module-literal configuration).

The 7-class RoboSub configuration at 640x360 (ResNet-18, FPN 256, 8
prototypes, anchor scales 24-384), the bf16 ``Yolact`` with the JAX
package's initialisers, batch 24, Adam with gradient clipping, the
capped mask loss (``max_positive_anchors`` 64), the reference's
augmentation pipeline (channel shuffle, colour jitter, noise, flips, blur,
shift-scale-rotate and perspective with 254-invalid fill), per-batch loss
logging, best-validation checkpoints with the three configurations beside
them, per-layer watch statistics.

Run on the card:
  python -m tauv_vision_tpu_torch.scripts.train_yolact \\
      --dataset-roots ~/datasets/a --results-dir ~/runs/yolact --no-figures

``main(argv, device="cpu")`` runs it on the CPU.  Not here yet: the
figures (ROADMAP Queue 1 item 3.2: without ``--no-figures`` the CLI
raises) and data-parallel training (Queue 1 item 3.3).
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from tauv_vision_tpu_torch.configs import (
    ClassConfig,
    ClassConfigSet,
    YolactModelConfig,
    YolactTrainConfig,
)
from tauv_vision_tpu_torch.data import augment
from tauv_vision_tpu_torch.data.dataset_dir import Split
from tauv_vision_tpu_torch.data.loader import BatchLoader, ConcatDataset
from tauv_vision_tpu_torch.data.segmentation_dataset import (
    SegmentationDataset,
    collate_segmentation_samples,
)
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import JsonlWriter, MultiWriter, StdoutWriter
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_yolact_eval_step, make_yolact_train_step
from tauv_vision_tpu_torch.train.trainer import Trainer, TrainerConfig

INIT_SEED = 0           # the JAX CLI's jax.random.key(0)

# Module-literal run config (yolact/scripts/train.py:28-120).
model_config = YolactModelConfig(
    in_w=640, in_h=360, feature_depth=256, n_classes=7, n_prototype_masks=8,
    n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
    n_prediction_head_layers=1, n_classification_layers=0, n_box_layers=0,
    n_mask_layers=0, n_fpn_downsample_layers=2,
    anchor_scales=(24, 48, 96, 192, 384), anchor_aspect_ratios=(1.0,),
    box_variances=(0.1, 0.2), iou_pos_threshold=0.4, iou_neg_threshold=0.3,
    negative_example_ratio=3,
)

train_config = YolactTrainConfig(
    lr=1e-3, momentum=0.9, weight_decay=0.0, grad_max_norm=1.0,
    n_epochs=200, batch_size=24, epoch_n_batches=100,
    weight_save_interval=1,
    channel_shuffle_p=0.2, color_jitter_p=0.8,
    color_jitter_brightness=0.4, color_jitter_contrast=0.4,
    color_jitter_saturation=0.4, color_jitter_hue=0.1,
    gaussian_noise_p=0.4, gaussian_noise_var_limit=(10.0, 50.0),
    horizontal_flip_p=0.5, vertical_flip_p=0.1,
    blur_limit=(3, 7), blur_p=0.3,
    ssr_p=0.5, ssr_shift_limit=(-0.1, 0.1), ssr_scale_limit=(-0.2, 0.2),
    ssr_rotate_limit=(-15, 15),
    perspective_p=0.3, perspective_scale_limit=(0.05, 0.1),
    min_visibility=0.3, n_workers=4,
)

class_config = ClassConfigSet(
    configs=tuple(
        ClassConfig(id, i + 1)
        for i, id in enumerate(
            ("sample_24_coral", "sample_24_nautilus", "torpedo_24",
             "torpedo_24_octagon", "buoy_24", "gate_24", "bin_24")
        )
    )
)


def build_train_transform(mc: YolactModelConfig, tc: YolactTrainConfig):
    """yolact/scripts/train.py:413-455 restated."""
    return augment.Compose(
        [
            augment.ChannelShuffle(p=tc.channel_shuffle_p),
            augment.ColorJitter(
                p=tc.color_jitter_p, brightness=tc.color_jitter_brightness,
                contrast=tc.color_jitter_contrast,
                saturation=tc.color_jitter_saturation, hue=tc.color_jitter_hue,
            ),
            augment.GaussNoise(p=tc.gaussian_noise_p,
                               var_limit=tc.gaussian_noise_var_limit),
            augment.HorizontalFlip(p=tc.horizontal_flip_p),
            augment.VerticalFlip(p=tc.vertical_flip_p),
            augment.Blur(p=tc.blur_p, blur_limit=tc.blur_limit),
            augment.ShiftScaleRotate(
                p=tc.ssr_p, shift_limit=tc.ssr_shift_limit,
                scale_limit=tc.ssr_scale_limit,
                rotate_limit=tc.ssr_rotate_limit,
            ),
            augment.Perspective(p=tc.perspective_p,
                                scale_limit=tc.perspective_scale_limit),
            augment.Resize(mc.in_h, mc.in_w),
        ],
        min_visibility=tc.min_visibility,
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-roots", nargs="+", required=True)
    parser.add_argument("--results-dir", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument(
        "--watch-every", type=int, default=0,
        help="log per-layer param/grad stats every N steps (wandb.watch, "
             "reference yolact/scripts/train.py:480)",
    )
    parser.add_argument("--no-figures", action="store_true")
    return parser


def main(argv=None, device=DEFAULT_DEVICE) -> TrainState:
    """Parse ``argv``, train at the module-literal configuration, and
    return the final ``TrainState``; the model lives on ``device`` (the
    card unless the caller asks for the CPU)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    if not args.no_figures:
        raise NotImplementedError(
            "the mask figures are not ported yet (ROADMAP Queue 1 item 3.2); "
            "pass --no-figures")
    mc, tc = model_config, train_config

    model = Yolact(mc, dtype=torch.bfloat16, init="flax",
                   generator=torch.Generator().manual_seed(INIT_SEED), device=device)

    class_map = {c.id: c.index for c in class_config.configs}
    train_transform = build_train_transform(mc, tc)
    val_transform = augment.Compose([augment.Resize(mc.in_h, mc.in_w)])

    train_datasets = [
        SegmentationDataset(pathlib.Path(r).expanduser(), Split.TRAIN,
                            class_map, train_transform)
        for r in args.dataset_roots
    ]
    val_datasets = [
        SegmentationDataset(pathlib.Path(r).expanduser(), Split.VAL,
                            class_map, val_transform)
        for r in args.dataset_roots
    ]

    def collate(samples):
        return collate_segmentation_samples(samples, tc.max_objects)

    train_loader = BatchLoader(
        ConcatDataset(train_datasets), tc.batch_size, collate, n_workers=tc.n_workers,
    )
    val_loader = BatchLoader(
        ConcatDataset(val_datasets), tc.batch_size, collate,
        shuffle=False, n_workers=tc.n_workers,
    )

    state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, tc.grad_max_norm))
    results_dir = pathlib.Path(args.results_dir).expanduser()
    checkpoints = CheckpointManager(results_dir / "checkpoints")
    if args.checkpoint:
        state = CheckpointManager(pathlib.Path(args.checkpoint)).restore(state)

    train_step = make_yolact_train_step(mc, tc)
    watch_step = None
    if args.watch_every > 0:
        watch_step = make_yolact_train_step(mc, tc, watch=True)
    eval_step = make_yolact_eval_step(mc, tc)

    writer = MultiWriter(StdoutWriter(), JsonlWriter(results_dir / "metrics.jsonl"))
    trainer = Trainer(
        train_step, eval_step, state,
        TrainerConfig(
            n_epochs=tc.n_epochs,
            epoch_n_batches=tc.epoch_n_batches,
            weight_save_interval=tc.weight_save_interval,
            keep_best=True,
            overfit_single_batch=args.overfit,
            watch_every=args.watch_every,
        ),
        checkpoints=checkpoints,
        writer=writer,
        watch_step=watch_step,
    )
    try:
        return trainer.fit(
            lambda: iter(train_loader),
            lambda: iter(val_loader),
            configs={
                "model_config": mc,
                "train_config": tc,
                "class_config": class_config,
            },
        )
    finally:
        writer.close()


if __name__ == "__main__":
    main()
