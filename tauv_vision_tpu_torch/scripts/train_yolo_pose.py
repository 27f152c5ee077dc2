"""YOLO-Pose training entry point (counterpart of
``tauv_vision_tpu/scripts/train_yolo_pose.py``, with the same flags and
module-literal configuration).

The Falling Things single-object recipe: the 21-class configuration at
960x480 (ResNet-18, FPN 64, 16 prototypes, a two-stage Pointnet of 9
keypoints), the bf16 ``YoloPose`` with the JAX package's initialisers,
batch 4, Adam after global-norm clipping at 1 with a linear warm-up of
the learning rate over ``--warmup-epochs`` epochs, the mask, belief and
affinity losses over each sample's 16 positives of highest IoU,
per-batch loss logging, a checkpoint every 5 epochs with the model
configuration beside it.  The frames go in as ``/ 255`` with no mean or
stddev, as the JAX CLI feeds them.

Run on the card:
  python -m tauv_vision_tpu_torch.scripts.train_yolo_pose \\
      --fat-root ~/falling_things/fat --results-dir ~/runs/yp --no-figures

``main(argv, device="cpu")`` runs it on the CPU.  Not here yet: the
figures (ROADMAP Queue 1: without ``--no-figures`` the CLI raises).
"""

from __future__ import annotations

import argparse
import pathlib

import cv2
import numpy as np
import torch

from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig
from tauv_vision_tpu_torch.data.falling_things import (
    FallingThingsDataset,
    FallingThingsEnvironment,
    FallingThingsObject,
    FallingThingsVariant,
)
from tauv_vision_tpu_torch.data.loader import BatchLoader
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.yolo_pose import YoloPose
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import JsonlWriter, MultiWriter, StdoutWriter
from tauv_vision_tpu_torch.train.state import TrainState, warmup_adam
from tauv_vision_tpu_torch.train.steps import make_yolo_pose_train_step
from tauv_vision_tpu_torch.train.trainer import Trainer, TrainerConfig
from tauv_vision_tpu_torch.train.yolo_pose_task import YoloPoseTruth

INIT_SEED = 0           # the JAX CLI's jax.random.key(0)

# Reference run config (yolo_pose/scripts/train.py:54-120), trimmed to
# the fields the model needs.
model_config = YoloPoseModelConfig(
    in_w=960, in_h=480, feature_depth=64, n_classes=21, n_prototype_masks=16,
    n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
    pointnet_layers=((7, 5, 64), (7, 5, 64)),
    pointnet_feature_depth=64,
    prototype_belief_depth=16, prototype_affinity_depth=16,
    belief_depth=9, affinity_depth=18,
    n_prediction_head_layers=1, n_fpn_downsample_layers=2,
    belief_sigma=2.0, affinity_radius=6.0,
    anchor_scales=(24, 48, 96, 192, 384), anchor_aspect_ratios=(1.0,),
    box_variances=(0.1, 0.2),
    iou_pos_threshold=0.5, iou_neg_threshold=0.4, negative_example_ratio=3,
)

MAX_OBJECTS = 8


def collate_fat(samples, in_h, in_w):
    """``FallingThingsSample`` list -> (img [B, in_h, in_w, 3] f32 in [0,
    1], ``YoloPoseTruth``) of numpy arrays, padded to ``MAX_OBJECTS``
    slots (box padding 1e-3 wide, seg 255); the seg map's class ids
    become object slots, a later slot of the same class taking the
    pixels."""
    b = len(samples)
    imgs = np.zeros((b, in_h, in_w, 3), np.float32)
    valid = np.zeros((b, MAX_OBJECTS), bool)
    classification = np.zeros((b, MAX_OBJECTS), np.int32)
    box = np.zeros((b, MAX_OBJECTS, 4), np.float32)
    box[..., 2:] = 1e-3
    seg = np.full((b, in_h, in_w), 255, np.int32)
    n_kp = 9
    keypoints = np.zeros((b, MAX_OBJECTS, n_kp, 2), np.float32)
    keypoint_valid = np.zeros((b, MAX_OBJECTS, n_kp), bool)
    centers = np.zeros((b, MAX_OBJECTS, 2), np.float32)

    for i, s in enumerate(samples):
        h0, w0 = s.img.shape[:2]
        imgs[i] = cv2.resize(s.img, (in_w, in_h)).astype(np.float32) / 255.0
        seg_resized = cv2.resize(
            s.seg_map.astype(np.float32), (in_w, in_h),
            interpolation=cv2.INTER_NEAREST,
        ).astype(np.int32)

        m = min(len(s.classifications), MAX_OBJECTS)
        valid[i, :m] = s.valid[:m]
        classification[i, :m] = s.classifications[:m]
        box[i, :m] = s.bounding_boxes[:m]
        remapped = np.full_like(seg_resized, 255)
        for slot in range(m):
            remapped[seg_resized == s.classifications[slot]] = slot
        seg[i] = remapped

        scale_y = in_h / h0
        scale_x = in_w / w0
        kp = s.projected_cuboids[:m]  # [m, 9, 2] (y, x) px at the frame's size
        keypoints[i, :m, :, 0] = kp[..., 0] * scale_y
        keypoints[i, :m, :, 1] = kp[..., 1] * scale_x
        keypoint_valid[i, :m] = True
        centers[i, :m] = kp[:, 0] * np.asarray([scale_y, scale_x])

    truth = YoloPoseTruth(
        valid=valid, classification=classification, box=box, seg_map=seg,
        keypoints=keypoints, keypoint_valid=keypoint_valid, centers=centers,
    )
    return imgs, truth


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--fat-root", required=True)
    parser.add_argument("--results-dir", required=True)
    parser.add_argument("--object", default="MustardBottle")
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--n-epochs", type=int, default=60)
    parser.add_argument("--epoch-n-batches", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--warmup-epochs", type=int, default=10)
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--watch-every", type=int, default=0)
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
            "the YOLO-Pose figures are not ported yet (ROADMAP Queue 1); pass --no-figures")
    mc = model_config

    dataset = FallingThingsDataset(
        args.fat_root, FallingThingsVariant.SINGLE,
        list(FallingThingsEnvironment),
        objects=[FallingThingsObject[args.object]],
    )
    loader = BatchLoader(
        dataset, args.batch_size,
        lambda s: collate_fat(s, mc.in_h, mc.in_w),
        n_workers=4,
    )

    model = YoloPose(mc, dtype=torch.bfloat16, init="flax",
                     generator=torch.Generator().manual_seed(INIT_SEED), device=device)
    state = TrainState(model, warmup_adam(model.parameters(), args.lr,
                                          args.warmup_epochs * args.epoch_n_batches, 1.0))
    watch_step = make_yolo_pose_train_step(mc, watch=True) if args.watch_every > 0 else None

    results_dir = pathlib.Path(args.results_dir).expanduser()
    writer = MultiWriter(StdoutWriter(), JsonlWriter(results_dir / "metrics.jsonl"))
    trainer = Trainer(
        make_yolo_pose_train_step(mc), None, state,
        TrainerConfig(
            n_epochs=args.n_epochs, epoch_n_batches=args.epoch_n_batches,
            weight_save_interval=5, keep_best=False,
            overfit_single_batch=args.overfit,
            watch_every=args.watch_every,
        ),
        checkpoints=CheckpointManager(results_dir / "checkpoints"),
        writer=writer,
        watch_step=watch_step,
    )
    try:
        return trainer.fit(lambda: iter(loader), configs={"model_config": mc})
    finally:
        writer.close()


if __name__ == "__main__":
    main()
