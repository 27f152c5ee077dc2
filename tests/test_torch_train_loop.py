"""The port's optimizer, checkpoints and trainer.

- ``adam_with_clip`` against ``optax.chain(clip_by_global_norm, adam)``
  and ``warmup_adam`` against the JAX package's, over 5 steps on a small
  tree of f32 parameters with the same gradients, the clip biting on some
  steps and not on others: within 1e-7.
- The counterparts of ``tests/test_checkpoint_trainer.py``: a checkpoint
  round trip (parameters, BatchNorm statistics, optimizer state and step
  restored into a fresh model), the configuration manifest, and the
  trainer's interval and best-validation checkpoints with JSONL metrics.
- A short overfit of a narrow CenterNet (two strided convs with training
  BatchNorm, a deformable block, a depthwise upsample, the heads) on one
  batch of squares through ``Trainer(overfit_single_batch=True)`` and
  ``make_centernet_train_step``, with the JAX integration test's bar
  (``tests/test_integration_train.py``): the last loss below half the
  first.
"""

import dataclasses
import json
from math import pi

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from tauv_vision_tpu.train.state import adam_with_clip as jax_adam_with_clip
from tauv_vision_tpu.train.state import warmup_adam as jax_warmup_adam
from tauv_vision_tpu_torch.configs import CenternetModelConfig, CenternetTrainConfig
from tauv_vision_tpu_torch.configs.centernet import get_head_channels
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centerpoint_dla import (
    DeformConvBlock,
    DepthwiseUpsample,
    prediction_from_heads,
)
from tauv_vision_tpu_torch.models.layers import Conv2d, batch_norm, flax_init_parameters
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import JsonlWriter, MultiWriter, StdoutWriter
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip, warmup_adam
from tauv_vision_tpu_torch.train.steps import make_centernet_eval_step, make_centernet_train_step
from tauv_vision_tpu_torch.train.trainer import Trainer, TrainerConfig
from torch_parity import square_configs, torch_threads

ADAM_TOL = 1e-7
SHAPES = {"conv": (4, 3, 3, 3), "bias": (4,), "dense": (7, 4)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("kind", ["adam_with_clip", "warmup_adam"])
def test_torch_optimizer_matches_optax(kind):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    # Global norms from ~0.1 to ~20 against a max norm of 1.
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
             for scale in (0.02, 3.0, 0.01, 1.5, 0.05)]
    lr, max_norm, warmup = 1e-2, 1.0, 3
    if kind == "adam_with_clip":
        tx = jax_adam_with_clip(lr, max_norm)
    else:
        tx = jax_warmup_adam(lr, warmup, max_norm)
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jax_params)

    port = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    if kind == "adam_with_clip":
        opt = adam_with_clip(port.values(), lr, max_norm)
    else:
        opt = warmup_adam(port.values(), lr, warmup, max_norm)
    clipped = 0
    for g in grads:
        clipped += float(optax.global_norm(g)) >= max_norm
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in port.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in port.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[k]),
                                       rtol=ADAM_TOL, atol=ADAM_TOL, err_msg=k)
    assert 0 < clipped < len(grads)


class Tiny(nn.Module):
    """conv -> training BatchNorm -> mean -> dense, as the JAX test's."""

    def __init__(self, seed):
        super().__init__()
        self.conv = Conv2d(3, 4, 3, padding=1)
        self.bn = batch_norm(4)
        self.dense = nn.Linear(4, 1)
        flax_init_parameters(self, torch.Generator().manual_seed(seed))

    def forward(self, x):
        return self.dense(self.bn(self.conv(x)).mean(dim=(2, 3)))


@dataclasses.dataclass
class Loss:
    total: torch.Tensor


def _tiny_state(seed=0):
    model = Tiny(seed)
    return TrainState(model, adam_with_clip(model.parameters(), 1e-3, 1.0))


def _tiny_step(state, img, truth):
    state.model.train()
    state.optimizer.zero_grad()
    loss = ((state.model(img) - truth) ** 2).sum()
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, Loss(loss.detach())


def test_torch_checkpoint_roundtrip(tmp_path):
    state = _tiny_state()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 8, 8)).astype(np.float32))
    state, _ = _tiny_step(state, x, torch.ones(2, 1))
    manager = CheckpointManager(tmp_path / "ckpts")
    manager.save(1, state, metrics={"val_loss": 0.5})
    assert manager.latest_step() == 1

    restored = manager.restore(_tiny_state(seed=1))
    for (name, a), b in zip(restored.model.state_dict().items(),
                            state.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    want = state.optimizer.state_dict()
    got = restored.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(got["state"][i][k], v, rtol=0, atol=0)
    assert restored.step == state.step == 1
    # The next step from the restored state equals the next step from the
    # saved one.
    _, a = _tiny_step(restored, x, torch.ones(2, 1))
    _, b = _tiny_step(state, x, torch.ones(2, 1))
    assert float(a.total) == float(b.total)
    manager.close()


def test_torch_checkpoint_config_manifest(tmp_path):
    manager = CheckpointManager(tmp_path / "ckpts")
    cfg = CenternetModelConfig(in_h=64, in_w=64, backbone_heights=(1,), backbone_channels=(8, 8),
                               downsamples=2, angle_bin_overlap=pi / 3)
    manager.save_configs({"model_config": cfg})
    assert CenternetModelConfig(**manager.load_config("model_config")) == cfg
    manager.close()


def test_torch_trainer_best_val_policy(tmp_path):
    """The trainer writes interval and best-validation checkpoints and
    JSONL metrics, and the loss falls."""
    x = np.random.default_rng(0).normal(size=(2, 8, 8, 3)).astype(np.float32)
    y = np.ones((2, 1), np.float32)
    manager = CheckpointManager(tmp_path / "ckpts")
    trainer = Trainer(
        _tiny_step, None, _tiny_state(),
        TrainerConfig(n_epochs=3, epoch_n_batches=2, weight_save_interval=1),
        checkpoints=manager,
        writer=MultiWriter(StdoutWriter(), JsonlWriter(tmp_path / "metrics.jsonl")),
    )
    trainer.fit(lambda: iter([(x, y)] * 2))

    assert manager.latest_step() == 6
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    assert len(lines) >= 6  # 2 batches x 3 epochs
    first = json.loads(lines[0])["train/total"]
    last = json.loads(lines[-1])["train/total"]
    assert last < first
    manager.close()


class NarrowCenternet(nn.Module):
    """A narrow CenterNet for the CPU: two strided convs with BatchNorm down
    to stride 4, a deformable block, a depthwise x2 upsample of a stride-8
    branch, and the heads of ``get_head_channels`` (3x3 conv, ReLU, 1x1
    conv; the heatmap heads' biases at -2.19)."""

    def __init__(self, object_config, width=16):
        super().__init__()
        self.object_config = object_config
        self.stem = nn.Sequential(
            Conv2d(3, width, 3, 2, 1, bias=False), batch_norm(width), nn.ReLU(),
            Conv2d(width, width, 3, 2, 1, bias=False), batch_norm(width), nn.ReLU())
        self.down = nn.Sequential(Conv2d(width, width, 3, 2, 1, bias=False), batch_norm(width),
                                  nn.ReLU())
        self.up = DepthwiseUpsample(width, 2)
        self.dcn = DeformConvBlock(width, 32, deform=True)
        self.heads = nn.ModuleList(
            nn.Sequential(Conv2d(32, 32, 3, padding=1), nn.ReLU(), Conv2d(32, n, 1))
            for n in get_head_channels(object_config))
        flax_init_parameters(self, torch.Generator().manual_seed(0))
        with torch.no_grad():
            for i in ((0, 1) if object_config.train_keypoints else (0,)):
                self.heads[i][2].bias.fill_(-2.19)

    def forward(self, img):
        x = self.stem(img)
        x = self.dcn(x + self.up(self.down(x)))
        return prediction_from_heads(self.object_config,
                                     [h(x).permute(0, 2, 3, 1) for h in self.heads])


def test_torch_narrow_centernet_overfits_one_batch():
    oc, mc = square_configs(32, 32)
    mc = dataclasses.replace(mc, in_h=32, in_w=32)
    tc = CenternetTrainConfig(
        lr=2e-3, batch_size=4, n_batches=0, n_epochs=1,
        heatmap_focal_loss_a=2.0, heatmap_focal_loss_b=4.0, heatmap_sigma_factor=0.1,
        keypoint_heatmap_sigma=1.5, keypoint_affinity_sigma=1.5,
        loss_lambda_keypoint_heatmap=1.0, loss_lambda_keypoint_affinity=0.01,
        loss_lambda_size=0.1, loss_lambda_offset=0.0, loss_lambda_angle=0.1,
        loss_lambda_depth=0.0, max_objects=2)
    model = NarrowCenternet(oc).eval()
    batch = generate_square_batch(np.random.default_rng(0), 4, SquareDatasetConfig(
        in_h=32, in_w=32, max_objects=1, min_side=6, max_side=12, keypoints=True))
    totals = []

    class Record:
        def log(self, metrics, step):
            totals.append(metrics["train/total"])

        def close(self):
            pass

    trainer = Trainer(
        make_centernet_train_step(mc, tc, oc), make_centernet_eval_step(mc, tc, oc),
        TrainState(model, adam_with_clip(model.parameters(), tc.lr, 1.0)),
        TrainerConfig(n_epochs=1, epoch_n_batches=150, overfit_single_batch=True),
        writer=Record())
    state = trainer.fit(lambda: iter([batch] * 150))
    assert state.step == 150 and len(totals) == 150
    assert np.isfinite(totals[-1])
    assert totals[-1] < 0.5 * totals[0], (totals[0], totals[-1])
    assert not model.training
