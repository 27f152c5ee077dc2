"""CenterNet training entry point (counterpart of
``tauv_vision_tpu/scripts/train_centernet.py``, with the same flags).

Multi-dataset concat, the model in bf16 with the flax initialisers as the
JAX CLI builds it, optional warm start, Adam with gradient clipping,
per-batch loss logging, epoch checkpoints, per-layer watch statistics.  The
config module names the model, training and object configurations
(``model_config``, ``train_config``, ``object_config``) and may pick the
backbone family (``backbone``): "dla34" (the default) is the DCN
``CenterpointDLA34`` (deformable IDA with a 3-cell window, the JAX
model's defaults), "dla" the custom ``Centernet`` built from
``backbone_heights``, ``backbone_channels`` and ``downsamples``.

Run on the card:
  python -m tauv_vision_tpu_torch.scripts.train_centernet \\
      --dataset-roots ~/datasets/a ~/datasets/b \\
      --results-dir ~/runs/centernet \\
      --config tauv_vision_tpu_torch.configs.samples_torpedo --no-figures

Data-parallel on N cards of a host (one rank a card, NCCL; ranks that
share a card use gloo):
  torchrun --nproc-per-node N -m tauv_vision_tpu_torch.scripts.train_centernet \\
      --dataset-roots ... --results-dir ... --no-figures

``train_config.batch_size`` is the global batch, as in the JAX CLI, and
must divide by N: each rank reads its rows of every global batch
(``BatchLoader(shard=)``) on ``cuda:LOCAL_RANK``, and the steps sum the
ranks' gradients (``train/steps.py``).  Only rank 0 writes the metrics
and the checkpoints, which load in one process.

``main(argv, device="cpu")`` runs it on the CPU.  Not here yet: the
heatmap figures (ROADMAP Queue 1 item 3: without ``--no-figures`` the
CLI raises).
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
from tauv_vision_tpu_torch.models.centernet import Centernet
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.parallel.distributed import join_data_mesh, shutdown
from tauv_vision_tpu_torch.parallel.mesh import replicate
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
    CPU), under ``torchrun`` on this rank's device of that type."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    mesh, joined = join_data_mesh(device)
    try:
        return _train(args, mesh.device if mesh else device, mesh)
    finally:
        if joined:
            shutdown()


def _train(args, device, mesh) -> TrainState:
    """``main``'s run on ``device``, data-parallel over ``mesh`` when one
    is given."""
    config_module = importlib.import_module(args.config)
    model_config = config_module.model_config
    train_config = config_module.train_config
    object_config = config_module.object_config
    backbone = getattr(config_module, "backbone", "dla34")
    if not args.no_figures:
        raise NotImplementedError(
            "the heatmap figures are not ported yet (ROADMAP Queue 1 item 3); "
            "pass --no-figures")

    generator = torch.Generator().manual_seed(INIT_SEED)
    if backbone == "dla34":
        model = CenterpointDLA34(
            object_config, device=device, deform=True, dcn_max_offset=DCN_MAX_OFFSET,
            dtype=torch.bfloat16, init="flax", generator=generator)
    else:
        model = Centernet(
            object_config, model_config.backbone_heights, model_config.backbone_channels,
            model_config.downsamples, generator, device, dtype=torch.bfloat16)

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

    shard = (mesh.rank, mesh.size) if mesh else None
    train_loader = BatchLoader(
        ConcatDataset(train_datasets), train_config.batch_size, collate,
        n_workers=train_config.n_workers or 4, shard=shard,
    )
    val_loader = BatchLoader(
        ConcatDataset(val_datasets), train_config.batch_size, collate,
        shuffle=False, n_workers=train_config.n_workers or 4, shard=shard,
    )

    state = TrainState(model, adam_with_clip(model.parameters(), train_config.lr,
                                             train_config.grad_max_norm))
    results_dir = pathlib.Path(args.results_dir).expanduser()
    lead = mesh is None or mesh.rank == 0
    checkpoints = CheckpointManager(results_dir / "checkpoints") if lead else None
    if args.checkpoint:
        state = CheckpointManager(pathlib.Path(args.checkpoint)).restore(state)
    if mesh:
        replicate(model, mesh)

    train_step = make_centernet_train_step(model_config, train_config, object_config,
                                           mesh=mesh)
    watch_step = None
    if args.watch_every > 0:
        watch_step = make_centernet_train_step(model_config, train_config, object_config,
                                               watch=True, mesh=mesh)
    eval_step = make_centernet_eval_step(model_config, train_config, object_config, mesh=mesh)

    writer = (MultiWriter(StdoutWriter(), JsonlWriter(results_dir / "metrics.jsonl")) if lead
              else None)
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
        mesh=mesh,
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
        if writer is not None:
            writer.close()


if __name__ == "__main__":
    main()
