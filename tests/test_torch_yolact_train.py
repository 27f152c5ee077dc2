"""The port's YOLACT training, end to end on the CPU.

- The single-batch overfit of JAX's ``tests/test_integration_train.py``
  (``test_yolact_single_batch_overfit``): its narrow f32 YOLACT (64x64,
  a 16-wide FPN, 4 prototypes, 2 classes, the mask loss capped at 16),
  its truth (two painted boxes a sample, ``_make_yolact_truth``), Adam
  with clipping at lr 1e-3, 60 steps through ``Trainer`` in overfit mode:
  the last loss below 0.6 of the first, every term finite.
- ``scripts/train_yolact.main(argv, device="cpu")`` on two directories
  written by ``write_square_seg_dataset`` (64x96 PNGs of the CLI's 7
  classes), with the module-literal configs shrunk by the test (64x96,
  a 16-wide FPN, batch 2, two epochs, one loader thread): the bf16 YOLACT
  trains with ``--watch-every 1``; every train and validation loss is
  finite, the watch lines cover every trained parameter, checkpoints are
  kept (each epoch's, and the best validation's), the manifest holds the
  three configurations as JAX's loaders read them, and a second run
  warm-starts from the checkpoints (``--checkpoint``): its model and Adam
  moments before training equal the saved ones bit for bit.
- It raises without ``--no-figures`` (the figures are not ported) and, on
  a machine without a card, when no device is given.
"""

import copy
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from tauv_vision_tpu import configs as jax_configs
from tauv_vision_tpu_torch.configs import YolactModelConfig, YolactTrainConfig
from tauv_vision_tpu_torch.data.synthetic import write_square_seg_dataset
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.scripts import train_yolact
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import MultiWriter
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_yolact_train_step
from tauv_vision_tpu_torch.train.trainer import Trainer, TrainerConfig
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth
from test_integration_train import _make_yolact_truth
from torch_parity import SMALL_YOLACT, torch_threads

OVERFIT_STEPS = 60


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


class _Totals:
    def __init__(self):
        self.records = []

    def log(self, metrics, step):
        self.records.append(metrics)

    def close(self):
        pass


def test_torch_yolact_single_batch_overfit():
    cfg = YolactModelConfig(**dict(SMALL_YOLACT, iou_pos_threshold=0.4,
                                   iou_neg_threshold=0.3))
    tc = YolactTrainConfig(lr=1e-3, momentum=0.9, weight_decay=0.0, grad_max_norm=1.0,
                           n_epochs=1, batch_size=2, epoch_n_batches=OVERFIT_STEPS,
                           max_objects=2, max_positive_anchors=16)
    img, truth = _make_yolact_truth(np.random.default_rng(1), 2, 2, 64, 64)
    truth = YolactTruth(**{f.name: np.asarray(getattr(truth, f.name))
                           for f in dataclasses.fields(YolactTruth)})
    model = Yolact(cfg, init="flax", generator=torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, tc.grad_max_norm))
    totals = _Totals()
    trainer = Trainer(make_yolact_train_step(cfg, tc), None, state,
                      TrainerConfig(n_epochs=1, epoch_n_batches=OVERFIT_STEPS,
                                    overfit_single_batch=True),
                      writer=MultiWriter(totals))
    trainer.fit(lambda: iter([(np.asarray(img), truth)] * OVERFIT_STEPS))
    losses = [r["train/total"] for r in totals.records]
    assert len(losses) == OVERFIT_STEPS
    assert losses[-1] < 0.6 * losses[0], (losses[0], losses[-1])
    for field in ("classification", "box", "mask"):
        assert math.isfinite(totals.records[-1][f"train/{field}"])


H, W = 64, 96


@pytest.fixture
def cli(monkeypatch):
    """The CLI's module literals shrunk to 64x96, a 16-wide FPN, batch 2,
    two epochs and one loader thread."""
    monkeypatch.setattr(train_yolact, "model_config", dataclasses.replace(
        train_yolact.model_config, in_h=H, in_w=W, feature_depth=16,
        anchor_scales=(12, 24, 48, 96, 192)))
    monkeypatch.setattr(train_yolact, "train_config", dataclasses.replace(
        train_yolact.train_config, batch_size=2, n_epochs=2, n_workers=1))
    return train_yolact


def _records(results):
    with open(results / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


def test_torch_train_yolact_cli_trains_and_warm_starts(cli, tmp_path):
    labels = [c.id for c in cli.class_config.configs]
    roots = [tmp_path / f"d{i}" for i in range(2)]
    for i, root in enumerate(roots):
        write_square_seg_dataset(root, np.random.default_rng(i), 4, 2, H, W, labels,
                                 min_side=10, max_side=24)
    common = ["--dataset-roots", *map(str, roots), "--no-figures"]
    state = cli.main(common + ["--results-dir", str(tmp_path / "run"), "--watch-every", "1"],
                     device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    assert state.model.dtype == torch.bfloat16
    records = _records(tmp_path / "run")
    train = [r for r in records if "train/total" in r]
    val = [r for r in records if "val/total" in r]
    watch = [r for r in records if "watch/global_grad_norm" in r]
    assert len(train) == 8 and len(val) == 2 and len(watch) == 8
    assert all(math.isfinite(v) for r in train + val for k, v in r.items()
               if k.startswith(("train/", "val/")))
    assert all("train/mask_clipped" in r for r in train)
    trained = {n.replace(".", "/") for n, p in state.model.named_parameters()
               if p.grad is not None}
    assert all({k[len("watch/"):-len("/grad_norm")] for k in r if k.endswith("/grad_norm")}
               == trained for r in watch)

    directory = tmp_path / "run" / "checkpoints"
    manager = CheckpointManager(directory)
    assert manager.all_steps() == [4, 8]
    assert YolactModelConfig.load(directory / "model_config.json") == cli.model_config
    assert YolactTrainConfig.load(directory / "train_config.json") == cli.train_config
    assert (jax_configs.ClassConfigSet.load(directory / "class_config.json").to_dict()
            == cli.class_config.to_dict())
    assert dataclasses.asdict(jax_configs.YolactTrainConfig.load(
        directory / "train_config.json")) == cli.train_config.to_dict()

    saved = torch.load(directory / "8" / "state.pt", weights_only=True)
    restored = {}
    run_fit = Trainer.fit

    def capture(self, *args, **kwargs):
        restored["model"] = {k: v.clone() for k, v in self.state.model.state_dict().items()}
        restored["optimizer"] = copy.deepcopy(self.state.optimizer.state_dict())
        restored["step"] = self.global_step
        return run_fit(self, *args, **kwargs)

    Trainer.fit = capture
    try:
        warm = cli.main(common + ["--results-dir", str(tmp_path / "warm"),
                                  "--checkpoint", str(directory)], device="cpu")
    finally:
        Trainer.fit = run_fit
    assert restored["step"] == 8 and warm.step == 16
    assert all(torch.equal(v, saved["model"][k]) for k, v in restored["model"].items())
    moments = restored["optimizer"]["state"]
    assert len(moments) == len(saved["optimizer"]["state"]) == len(trained)
    assert all(torch.equal(moments[i][k], s[k]) for i, s in saved["optimizer"]["state"].items()
               for k in ("mu", "nu"))
    assert [r["step"] for r in _records(tmp_path / "warm") if "train/total" in r] == list(
        range(8, 16))


def test_torch_train_yolact_cli_raises_where_it_cannot_run(cli, tmp_path, monkeypatch):
    args = ["--dataset-roots", str(tmp_path), "--results-dir", str(tmp_path / "out")]
    with pytest.raises(NotImplementedError, match="no-figures"):
        cli.main(args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args + ["--no-figures"])
