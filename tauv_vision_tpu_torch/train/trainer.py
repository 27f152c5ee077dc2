"""The training loop (counterpart of ``tauv_vision_tpu/train/trainer.py``).

Every loss term logged each ``log_every`` steps, validation averages each
epoch, interval and best-validation checkpoints, a single-batch overfit
mode for debugging, per-layer watch statistics every ``watch_every``
steps, and data-parallel execution over a mesh (``mesh=``).  Figures
(JAX's ``figure_fn``) are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import torch

from tauv_vision_tpu_torch.parallel.mesh import Mesh, parallel
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import MetricWriter, StdoutWriter, losses_to_metrics
from tauv_vision_tpu_torch.train.state import TrainState


@dataclass
class TrainerConfig:
    n_epochs: int
    epoch_n_batches: int          # batches an epoch (cap on the loader)
    weight_save_interval: int = 1
    keep_best: bool = True        # the best-validation checkpoint
    log_every: int = 1
    overfit_single_batch: bool = False
    # Log per-layer param/grad statistics every N steps (the wandb.watch
    # equivalent, yolact/scripts/train.py:480), through a ``watch_step``
    # built with watch=True (it returns a third dict, ``train/watch.py``).
    watch_every: int = 0


class Trainer:
    """Runs ``train_step`` and ``eval_step`` (``train.steps``) over batches
    of numpy ``(img [B, H, W, 3], truth)``, moved to the model's device as
    NCHW f32 and tensors at each step (on the card through pinned host
    memory).  ``watch_step``, the train step built with ``watch=True``,
    takes the steps whose statistics ``watch_every`` logs.

    ``mesh``: every rank runs a ``Trainer`` over its host-local rows of
    each global batch (a loader sharded by rank, ``BatchLoader(shard=)``
    or ``make_grain_loader``), with steps built on the same mesh, whose
    losses are the global batch's on every rank; so the logged losses and
    the epoch and validation averages are the global ones.  The writer and
    the checkpoints act on rank 0 only (a barrier around each save), and
    only rank 0 prints."""

    def __init__(
        self,
        train_step: Callable,
        eval_step: Optional[Callable],
        state: TrainState,
        config: TrainerConfig,
        checkpoints: Optional[CheckpointManager] = None,
        writer: Optional[MetricWriter] = None,
        watch_step: Optional[Callable] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.train_step = train_step
        self.watch_step = watch_step
        self.eval_step = eval_step
        self.state = state
        self.config = config
        self.mesh = mesh
        self.lead = not parallel(mesh) or mesh.rank == 0
        self.checkpoints = checkpoints if self.lead else None
        self.writer = (writer or StdoutWriter()) if self.lead else _Silent()
        self.global_step = int(state.step)
        self.best_val_loss = float("inf")
        self.device = next(state.model.parameters()).device

    def _put(self, batch):
        img, truth = batch
        img = torch.as_tensor(img)
        if self.device.type == "cuda":
            img = img.pin_memory()
        img = img.to(self.device, non_blocking=True).permute(0, 3, 1, 2).contiguous()
        if not hasattr(truth, "to"):
            return img, torch.as_tensor(truth).to(self.device)
        return img, truth.to(self.device)

    def _watching(self) -> bool:
        return (self.watch_step is not None and self.config.watch_every > 0
                and self.global_step % self.config.watch_every == 0)

    def run_train_epoch(self, batches: Iterable, epoch: int) -> float:
        total = 0.0
        count = 0
        cached = None
        for batch_i, batch in enumerate(batches):
            if batch_i >= self.config.epoch_n_batches:
                break
            if self.config.overfit_single_batch:
                if cached is None:
                    cached = self._put(batch)
                img, truth = cached
            else:
                img, truth = self._put(batch)
            t0 = time.perf_counter()
            watch_stats = None
            if self._watching():
                self.state, losses, watch_stats = self.watch_step(self.state, img, truth)
            else:
                self.state, losses = self.train_step(self.state, img, truth)
            if batch_i % self.config.log_every == 0:
                metrics = losses_to_metrics(losses, "train/")
                metrics["train/step_time"] = time.perf_counter() - t0
                metrics["epoch"] = epoch
                self.writer.log(metrics, self.global_step)
            if watch_stats is not None:
                self.writer.log({k: float(v) for k, v in watch_stats.items()},
                                self.global_step)
            total += float(losses.total)
            count += 1
            self.global_step += 1
        return total / max(count, 1)

    def run_validation_epoch(self, batches: Iterable, epoch: int) -> float:
        if self.eval_step is None:
            return float("nan")
        total = 0.0
        count = 0
        sums: dict = {}
        for batch in batches:
            img, truth = self._put(batch)
            losses = self.eval_step(self.state, img, truth)
            for k, v in losses_to_metrics(losses, "val/").items():
                sums[k] = sums.get(k, 0.0) + v
            total += float(losses.total)
            count += 1
        if count:
            self.writer.log({k: v / count for k, v in sums.items()} | {"epoch": epoch},
                            self.global_step)
        return total / max(count, 1)

    def maybe_checkpoint(self, epoch: int, val_loss: float, configs=None):
        interval = self.config.weight_save_interval
        is_interval = interval > 0 and (epoch % interval == 0)
        is_best = self.config.keep_best and val_loss < self.best_val_loss
        if is_best:
            self.best_val_loss = val_loss
        if not (is_interval or is_best or (configs and epoch == 0)):
            return
        # Every rank takes the same decision (the losses are global), so
        # every rank reaches the barriers.
        if parallel(self.mesh):
            self.mesh.barrier()
        if self.checkpoints is not None:
            if configs and epoch == 0:
                self.checkpoints.save_configs(configs)
            if is_interval or is_best:
                self.checkpoints.save(self.global_step, self.state,
                                      metrics={"val_loss": val_loss, "epoch": epoch})
        if parallel(self.mesh):
            self.mesh.barrier()

    def fit(
        self,
        train_batches_fn: Callable[[], Iterable],
        val_batches_fn: Optional[Callable[[], Iterable]] = None,
        configs: Optional[dict] = None,
    ) -> TrainState:
        for epoch in range(self.config.n_epochs):
            train_loss = self.run_train_epoch(train_batches_fn(), epoch)
            val_loss = (self.run_validation_epoch(val_batches_fn(), epoch)
                        if val_batches_fn is not None else train_loss)
            self.maybe_checkpoint(epoch, val_loss, configs)
            if self.lead:
                print(f"epoch {epoch}: train={train_loss:.5g} val={val_loss:.5g}", flush=True)
        return self.state


class _Silent:
    """The writer of a rank that is not rank 0."""

    def log(self, metrics, step: int) -> None:
        pass

    def close(self) -> None:
        pass
