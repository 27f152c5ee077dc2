"""CenterNet training entry point (counterpart of
``tauv_vision_tpu/scripts/train_centernet.py``, with the same flags).

Multi-dataset concat, the DCN ``CenterpointDLA34`` in bf16 as the JAX CLI
builds it (its defaults: deformable IDA with a 3-cell window, the flax
initialisers), optional warm start, Adam with gradient clipping, per-batch
loss logging, epoch checkpoints, per-layer watch statistics.  The config
module names the model, training and object configurations
(``model_config``, ``train_config``, ``object_config``).

Run on the card:
  python -m tauv_vision_tpu_torch.scripts.train_centernet \\
      --dataset-roots ~/datasets/a ~/datasets/b \\
      --results-dir ~/runs/centernet \\
      --config tauv_vision_tpu_torch.configs.samples_torpedo --no-figures

``main(argv, device="cpu")`` runs it on the CPU.  Not here yet: the
heatmap figures (ROADMAP Queue 1 item 3.2: without ``--no-figures`` the
CLI raises), the custom ``backbone="dla"`` (Queue 1 item 6: raises) and
data-parallel training (Queue 1 item 3.3).
"""

from __future__ import annotations

import argparse
import importlib
import pathlib

import torch

from tauv_vision_tpu_torch.data import augment
from tauv_vision_tpu_torch.data.dataset_dir import Split
from tauv_vision_tpu_torch.data.loader import BatchLoader, ConcatDataset
from tauv_vision_tpu_torch.data.pose_dataset import PoseDataset, collate_pose_samples
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import JsonlWriter, MultiWriter, StdoutWriter
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import (
    make_centernet_eval_step,
    make_centernet_train_step,
)
from tauv_vision_tpu_torch.train.trainer import Trainer, TrainerConfig

DCN_MAX_OFFSET = 3.0    # the JAX CenterpointDLA34's default window
INIT_SEED = 0           # the JAX CLI's jax.random.key(0)


def build_train_transform(model_config, train_config):
    """The reference's albumentations train pipeline restated
    (centernet/scripts/train.py:144-167)."""
    return augment.Compose(
        [
            augment.ColorJitter(p=0.8),
            augment.GaussNoise(p=0.4),
            augment.Blur(p=0.3),
            augment.HorizontalFlip(p=0.5),
            augment.ShiftScaleRotate(p=0.5),
            augment.Resize(model_config.in_h, model_config.in_w),
        ],
        min_visibility=0.2,
    )


def build_val_transform(model_config):
    return augment.Compose([augment.Resize(model_config.in_h, model_config.in_w)])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-roots", nargs="+", required=True)
    parser.add_argument("--results-dir", required=True)
    parser.add_argument(
        "--config", default="tauv_vision_tpu_torch.configs.samples_torpedo",
        help="python module exposing model_config/train_config/object_config",
    )
    parser.add_argument("--checkpoint", default=None, help="warm-start path")
    parser.add_argument("--overfit", action="store_true")
    parser.add_argument("--epoch-n-batches", type=int, default=None)
    parser.add_argument(
        "--watch-every", type=int, default=0,
        help="log per-layer param/grad stats every N steps (wandb.watch)",
    )
    parser.add_argument(
        "--no-figures", action="store_true",
        help="disable per-val-epoch heatmap figures",
    )
    return parser


def main(argv=None, device=DEFAULT_DEVICE) -> TrainState:
    """Parse ``argv``, train, and return the final ``TrainState``; the
    model lives on ``device`` (the card unless the caller asks for the
    CPU)."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)

    config_module = importlib.import_module(args.config)
    model_config = config_module.model_config
    train_config = config_module.train_config
    object_config = config_module.object_config
    backbone = getattr(config_module, "backbone", "dla34")
    if backbone != "dla34":
        raise NotImplementedError(
            f"backbone {backbone!r}: the port has only the DLA-34 backbone; the custom "
            "'dla' backbone is ROADMAP Queue 1 item 6")
    if not args.no_figures:
        raise NotImplementedError(
            "the heatmap figures are not ported yet (ROADMAP Queue 1 item 3.2); "
            "pass --no-figures")

    model = CenterpointDLA34(
        object_config, device=device, deform=True, dcn_max_offset=DCN_MAX_OFFSET,
        dtype=torch.bfloat16, init="flax",
        generator=torch.Generator().manual_seed(INIT_SEED))

    train_transform = build_train_transform(model_config, train_config)
    val_transform = build_val_transform(model_config)

    label_map = object_config.label_id_to_index
    train_datasets = [
        PoseDataset(pathlib.Path(root).expanduser(), Split.TRAIN, label_map,
                    object_config, train_transform)
        for root in args.dataset_roots
    ]
    val_datasets = [
        PoseDataset(pathlib.Path(root).expanduser(), Split.VAL, label_map,
                    object_config, val_transform)
        for root in args.dataset_roots
    ]

    def collate(samples):
        return collate_pose_samples(
            samples, train_config.max_objects, train_config.max_keypoints
        )

    train_loader = BatchLoader(
        ConcatDataset(train_datasets), train_config.batch_size, collate,
        n_workers=train_config.n_workers or 4,
    )
    val_loader = BatchLoader(
        ConcatDataset(val_datasets), train_config.batch_size, collate,
        shuffle=False, n_workers=train_config.n_workers or 4,
    )

    state = TrainState(model, adam_with_clip(model.parameters(), train_config.lr,
                                             train_config.grad_max_norm))
    results_dir = pathlib.Path(args.results_dir).expanduser()
    checkpoints = CheckpointManager(results_dir / "checkpoints")
    if args.checkpoint:
        state = CheckpointManager(pathlib.Path(args.checkpoint)).restore(state)

    train_step = make_centernet_train_step(model_config, train_config, object_config)
    watch_step = None
    if args.watch_every > 0:
        watch_step = make_centernet_train_step(model_config, train_config, object_config,
                                               watch=True)
    eval_step = make_centernet_eval_step(model_config, train_config, object_config)

    writer = MultiWriter(StdoutWriter(), JsonlWriter(results_dir / "metrics.jsonl"))
    trainer = Trainer(
        train_step, eval_step, state,
        TrainerConfig(
            n_epochs=train_config.n_epochs,
            epoch_n_batches=args.epoch_n_batches or len(train_loader),
            weight_save_interval=train_config.weight_save_interval,
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
                "model_config": model_config,
                "train_config": train_config,
                "object_config": object_config,
            },
        )
    finally:
        writer.close()


if __name__ == "__main__":
    main()
