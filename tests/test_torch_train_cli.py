"""The port's CenterNet training CLI, end to end on the CPU, and its watch
statistics against the JAX package's.

- ``watch_metrics`` on a narrow net (a conv and a dense layer) against
  JAX's ``train/watch.py`` on the same parameters and gradients, named
  alike: every statistic within f32 rounding (rtol 1e-6).
- ``scripts/train_centernet.main(argv, device="cpu")`` on a 64x96
  dataset directory written by the port's writer (the synthetic squares,
  ``samples_torpedo``'s four classes and keypoint), with a config module
  of the test's own (``samples_torpedo`` at 64x96, batch 2, two epochs, a
  checkpoint each): the full-width bf16 DCN DLA-34 with its 3-cell window
  (the JAX CLI's model) trains with ``--overfit --no-figures
  --watch-every 1``; every logged loss and validation loss is finite, the
  watch lines cover every trained parameter, the checkpoints and the
  configurations are written, and a second run warm-starts from them
  (``--checkpoint``): its first step is the saved step's successor, and
  its model and Adam moments before training equal the saved ones bit
  for bit.  JAX's own DLA-34 CLI is not run here (a full-width compile).
- What the CLI does not do yet raises: the figures (without
  ``--no-figures``), the custom ``backbone="dla"``, and the card when
  there is none (no quiet CPU run).
"""

import dataclasses
import json
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tauv_vision_tpu.train.watch import watch_metrics as jax_watch_metrics
from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data.synthetic import write_square_pose_dataset
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.scripts import train_centernet
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.watch import watch_metrics
from torch_parity import torch_threads

H, W = 64, 96
CONFIG = """
import dataclasses
from tauv_vision_tpu_torch.configs import samples_torpedo as base
model_config = dataclasses.replace(base.model_config, in_h={h}, in_w={w})
train_config = dataclasses.replace(base.train_config, batch_size=2, n_epochs={epochs},
                                   n_workers=1, weight_save_interval=1)
object_config = base.object_config
backbone = "{backbone}"
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def test_torch_watch_metrics_match_jax():
    rng = np.random.default_rng(0)
    net = nn.Module()
    net.conv = nn.Conv2d(3, 8, 3)
    net.dense = nn.Linear(8, 4)
    params, grads = {}, {}
    for name, p in net.named_parameters():
        value = rng.normal(size=p.shape).astype(np.float32)
        grad = rng.normal(size=p.shape).astype(np.float32) * 10 ** rng.uniform(-3, 1)
        with torch.no_grad():
            p.copy_(torch.from_numpy(value))
        p.grad = torch.from_numpy(grad)
        layer, leaf = name.split(".")
        params.setdefault(layer, {})[leaf] = jnp.asarray(value)
        grads.setdefault(layer, {})[leaf] = jnp.asarray(grad)
    got = watch_metrics(net)
    want = jax_watch_metrics(params, grads)
    assert set(got) == set(want) and len(got) == 4 * 3 + 1
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


@pytest.fixture
def cli_run(tmp_path, monkeypatch):
    """Write the dataset and a config module; returns a runner of the CLI."""
    root = tmp_path / "dataset"
    labels = [c.id for c in samples_torpedo.object_config.configs]
    write_square_pose_dataset(root, np.random.default_rng(0), 4, 2, H, W, labels,
                              min_side=8.0, max_side=16.0)
    monkeypatch.syspath_prepend(str(tmp_path))

    def run(name, *flags, epochs=2, backbone="dla34", device="cpu"):
        (tmp_path / f"{name}.py").write_text(CONFIG.format(h=H, w=W, epochs=epochs,
                                                           backbone=backbone))
        sys.modules.pop(name, None)
        results = tmp_path / name
        argv = ["--dataset-roots", str(root), "--results-dir", str(results), "--config", name,
                *flags]
        return results, train_centernet.main(argv, device=device)

    return run


def _records(results):
    with open(results / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


def test_torch_train_cli_trains_and_warm_starts(cli_run, capsys):
    results, state = cli_run("cli_config", "--overfit", "--no-figures", "--watch-every", "1",
                             "--epoch-n-batches", "2")
    assert state.step == 4
    records = _records(results)
    train = [r for r in records if "train/total" in r]
    val = [r for r in records if "val/total" in r]
    watch = [r for r in records if "watch/global_grad_norm" in r]
    assert [r["step"] for r in train] == [0, 1, 2, 3] and len(val) == 2 and len(watch) == 4
    assert all(math.isfinite(r["train/total"]) for r in train)
    assert all(math.isfinite(r["val/total"]) for r in val)
    trained = {n.replace(".", "/") for n, p in state.model.named_parameters()
               if p.grad is not None}
    assert len(trained) > 250
    for r in watch:
        assert {k[len("watch/"):-len("/grad_norm")] for k in r
                if k.endswith("/grad_norm")} == trained
    assert train[-1]["train/total"] < train[0]["train/total"]     # one batch, overfit
    dcns = state.model.deform_convs()
    assert len(dcns) == 16 and all(m.max_offset == 3 for m in dcns)
    assert next(state.model.parameters()).device.type == "cpu"

    manager = CheckpointManager(results / "checkpoints")
    assert manager.all_steps() == [2, 4]
    assert manager.load_config("train_config")["batch_size"] == 2
    saved = torch.load(results / "checkpoints" / "4" / "state.pt", weights_only=True)

    # The warm start restores what was saved, bit for bit.
    model = CenterpointDLA34(samples_torpedo.object_config, device="cpu", deform=True,
                             dcn_max_offset=3, dtype=torch.bfloat16, init="flax")
    fresh = TrainState(model, adam_with_clip(model.parameters(), 5e-4, 1.0))
    restored = manager.restore(fresh)
    assert restored.step == 4
    for name, value in restored.model.state_dict().items():
        assert torch.equal(value, saved["model"][name]), name
    moments = restored.optimizer.state_dict()["state"]
    for i, s in saved["optimizer"]["state"].items():
        for k in ("mu", "nu"):
            assert torch.equal(moments[i][k], s[k]), (i, k)

    results2, state2 = cli_run("cli_warm", "--no-figures", "--checkpoint",
                               str(results / "checkpoints"), epochs=1)
    train2 = [r for r in _records(results2) if "train/total" in r]
    assert [r["step"] for r in train2] == [4, 5] and state2.step == 6
    assert all(math.isfinite(r["train/total"]) for r in train2)
    assert "epoch 0: train=" in capsys.readouterr().out


def test_torch_train_cli_refuses_what_it_lacks(cli_run):
    with pytest.raises(NotImplementedError, match="figures"):
        cli_run("cli_figures")
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        cli_run("cli_dla", "--no-figures", backbone="dla")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_run("cli_card", "--no-figures", device="cuda")


def test_torch_train_transforms_are_jax_recipe():
    mc = dataclasses.replace(samples_torpedo.model_config, in_h=H, in_w=W)
    train = train_centernet.build_train_transform(mc, samples_torpedo.train_config)
    assert [type(t).__name__ for t in train.transforms] == [
        "ColorJitter", "GaussNoise", "Blur", "HorizontalFlip", "ShiftScaleRotate", "Resize"]
    assert train.min_visibility == 0.2
    val = train_centernet.build_val_transform(mc)
    assert [(type(t).__name__, t.height, t.width) for t in val.transforms] == [("Resize", H, W)]
