"""The port's CenterNet training CLI data-parallel on 2 spawned gloo ranks
(127.0.0.1, one torch thread each) against the same CLI on one rank.

``scripts/train_centernet.main`` runs in each rank as under ``torchrun``
(``torch_dp_ranks.run_main``: the rank joins the spawned group, takes
its rows of every global batch through ``BatchLoader(shard=)`` and sums
its gradients with the other rank's), on a 64x96 dataset directory of the
synthetic squares (4 train and 2 validation samples) with a config module
of the test's own: the custom-DLA Centernet (``backbone = "dla"``, trees
of height 1, channels (8, 8, 16), bf16 as the CLI builds it) at global
batch 2, two batches, one epoch, a checkpoint at its end.  The module
trains on the validation transform (a resize): the augmentations draw
from one generator a dataset in the order its samples are read, which
the ranks' loaders do not share, so an augmented DP run would train on
other images than the single run.

- Every logged loss of the first step within 1e-5 relative of the single
  run's.  Past it the runs part by bf16 rounding: each rank's weight
  gradients come out of its bf16 convolutions rounded to bf16 before the
  ranks' sum, where the single run rounds the batch's sum once, so the
  summed gradients differ by ~2e-3 relative (median; in f32 the same
  step's differ by ~1e-6), and the second step and the validation after
  the first update differ by up to ~7e-3 (one bf16 ulp of
  ``max_size_error``).  Those are held within 1e-2 relative.  (The f32 DP
  step is held at 1e-5 in ``test_torch_data_parallel.py``.)
- Only rank 0 writes: its results directory holds as many metric lines as
  the single run's, the configurations and the checkpoint; rank 1's
  (``--results-dir`` names each rank's) is never made.
- The checkpoint loads in one process into a bare model, equal to both
  ranks' final models bit for bit.
"""

import json
import math
import sys

import pytest
import numpy as np
import torch

from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data.synthetic import write_square_pose_dataset
from tauv_vision_tpu_torch.models.centernet import Centernet
from tauv_vision_tpu_torch.parallel.distributed import spawn
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from torch_dp_ranks import run_main
from torch_parity import torch_threads

H, W = 64, 96
HEIGHTS, CHANNELS = (1, 1), (8, 8, 16)
LOSS_RTOL = 1e-5
BF16_STEP_RTOL = 1e-2   # after the first bf16 update (module docstring)
CONFIG = f"""
import dataclasses
from tauv_vision_tpu_torch.configs import samples_torpedo as base
from tauv_vision_tpu_torch.scripts import train_centernet
model_config = dataclasses.replace(base.model_config, in_h={H}, in_w={W},
                                   backbone_heights={HEIGHTS}, backbone_channels={CHANNELS})
train_config = dataclasses.replace(base.train_config, batch_size=2, n_epochs=1, n_workers=1,
                                   weight_save_interval=1)
object_config = base.object_config
backbone = "dla"
train_centernet.build_train_transform = (
    lambda mc, tc: train_centernet.build_val_transform(mc))
"""
MODULE = "tauv_vision_tpu_torch.scripts.train_centernet"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_dp")
    root = tmp / "dataset"
    labels = [c.id for c in samples_torpedo.object_config.configs]
    write_square_pose_dataset(root, np.random.default_rng(0), 4, 2, H, W, labels,
                              min_side=8.0, max_side=16.0)
    (tmp / "cli_dp_config.py").write_text(CONFIG)
    sys.path.insert(0, str(tmp))    # the spawned ranks inherit it
    try:
        def argv(results):
            return ["--dataset-roots", str(root), "--results-dir", str(tmp / results),
                    "--config", "cli_dp_config", "--no-figures", "--epoch-n-batches", "2"]

        dp = spawn(run_main, 2, MODULE, argv("dp{rank}"))
        one = spawn(run_main, 1, MODULE, argv("one"))[0]
    finally:
        sys.path.remove(str(tmp))
    return tmp, dp, one


def records(results):
    with open(results / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


def test_torch_train_cli_dp_logs_the_single_run_losses(runs):
    tmp, dp, one = runs
    got, want = records(tmp / "dp0"), records(tmp / "one")
    assert len(got) == len(want) == 3      # two steps and a validation
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 1, 2]
    n_losses = 0
    for g, w in zip(got, want):
        keys = {k for k in w if k.startswith(("train/", "val/")) and k != "train/step_time"}
        assert keys and keys == {k for k in g if k.startswith(("train/", "val/"))} - {
            "train/step_time"}
        for k in keys:
            n_losses += 1
            if w[k] == 0 or not math.isfinite(w[k]):
                assert g[k] == w[k] or (math.isnan(g[k]) and math.isnan(w[k])), k
                continue
            bar = LOSS_RTOL if w["step"] == 0 else BF16_STEP_RTOL
            assert abs(g[k] - w[k]) <= bar * abs(w[k]), (w["step"], k, g[k], w[k])
    assert n_losses > 20


def test_torch_train_cli_dp_only_rank0_writes(runs):
    tmp, dp, one = runs
    assert not (tmp / "dp1").exists()
    manager = CheckpointManager(tmp / "dp0" / "checkpoints")
    assert manager.all_steps() == CheckpointManager(tmp / "one" / "checkpoints").all_steps() == [2]
    assert manager.load_config("train_config")["batch_size"] == 2
    assert [r["step"] for r in dp] == [2, 2] and one["step"] == 2
    mc, oc = samples_torpedo.model_config, samples_torpedo.object_config
    fresh = Centernet(oc, HEIGHTS, CHANNELS, mc.downsamples, device="cpu", dtype=torch.bfloat16)
    restored = manager.restore(TrainState(fresh, adam_with_clip(fresh.parameters(), 1e-3, 1.0)))
    assert restored.step == 2
    for name, value in restored.model.state_dict().items():
        for rank in dp:
            assert torch.equal(value, rank["model"][name]), name
