"""YOLO-Pose training in the port against the JAX package: a train step,
the warm-up Adam, the Falling Things reader and ``collate_fat``, the CLI.

At ``tests/test_yolo_pose.py``'s small configuration (64x96) with
Falling Things' 21 classes and 9 keypoints, batch 2, on
the collated frames of ``write_square_fat_dataset`` (projected cubes of
the Falling Things layout, written under ``tmp_path``):

- the reader and ``collate_fat`` against the JAX package's on the same
  files, an empty frame and frames of several objects of one class among
  them (its seg pixels go to the later slot): every sample field and
  every batch array equal;
- one f32 train step of the port (``make_yolo_pose_train_step``) on the
  JAX package's weights drawn with numpy (``torch_parity.random_variables``)
  carried over by ``weights.yolo_pose_state_dict_from_flax``, against the
  JAX CLI's ``loss_fn`` under a jitted ``value_and_grad``.  The step is
  chaotic at this size (BatchNorm on batch statistics over 1x2 to 4x6
  maps at batch 2), so, as ``test_torch_yolact_step.py`` does, each
  quantity is held to the larger of a bar and ``YARDSTICK`` times the
  port's own largest move when the input is scaled by 1 +- 1e-6: each
  loss term 1e-5 relative, each parameter's gradient 1e-4 by relative L2,
  the BatchNorm running statistics 1e-5;
- the warm-up Adam (``warmup_adam``) fed JAX's raw gradients of three of
  JAX's own steps lands on optax's parameters within 1e-7, its first
  update moving nothing;
- one bf16 step from the JAX package's initialisers (``init="flax"``):
  losses and gradients finite, every gradient non-zero but those of the
  FPN's extra levels, which no anchor of the batch trains; the step's
  ``torch.profiler`` ranges, each module's mode given back, and a raise
  inside ``torch.inference_mode``;
- the CLI on the CPU with its model configuration narrowed to 64x96
  (monkeypatched): checkpoints with ``model_config.json`` beside them and
  ``metrics.jsonl`` written, watch lines; and it raises without
  ``--no-figures``, and without a card when the caller does not ask for
  the CPU.  Its module-literal configuration is JAX's and
  ``configs.BENCH_YOLO_POSE.model``.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.configs.yolo_pose import YoloPoseModelConfig as JaxYoloPoseModelConfig
from tauv_vision_tpu.data import falling_things as jax_fat
from tauv_vision_tpu.models.yolo_pose import YoloPose as JaxYoloPose
from tauv_vision_tpu.scripts import train_yolo_pose as jax_cli
from tauv_vision_tpu.train.state import TrainState as JaxTrainState
from tauv_vision_tpu.train.state import warmup_adam as jax_warmup_adam
from tauv_vision_tpu.train.yolo_pose_task import YoloPoseTruth as JaxTruth
from tauv_vision_tpu.train.yolo_pose_task import yolo_pose_loss as jax_yolo_pose_loss
from tauv_vision_tpu_torch.configs import BENCH_YOLO_POSE, YoloPoseModelConfig
from tauv_vision_tpu_torch.data import falling_things as port_fat
from tauv_vision_tpu_torch.data.synthetic import write_square_fat_dataset
from tauv_vision_tpu_torch.models.yolo_pose import YoloPose
from tauv_vision_tpu_torch.scripts import train_yolo_pose
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip, warmup_adam
from tauv_vision_tpu_torch.train import steps as train_steps
from tauv_vision_tpu_torch.train.steps import make_yolo_pose_train_step, model_mode
from tauv_vision_tpu_torch.train.yolact_task import match_anchor_sets
from tauv_vision_tpu_torch.weights import yolo_pose_state_dict_from_flax
from test_torch_yolo_pose import SMALL
from torch_parity import random_variables, torch_threads

H, W, BATCH = 64, 96, 2
FRAME_H, FRAME_W = 48, 80       # the written frames: collate_fat resizes them
# Falling Things' 21 classes (the CLI's) and an object's 9 keypoints
# (``collate_fat``'s); the small configuration has 2 and 3.
TRAIN_SMALL = dict(SMALL, n_classes=21, belief_depth=9, affinity_depth=18)
CFG = YoloPoseModelConfig(**TRAIN_SMALL)
JAX_CFG = JaxYoloPoseModelConfig(**TRAIN_SMALL)
LOSS_FIELDS = ("total", "classification", "box", "mask", "belief", "affinity")
BARS = dict(loss=1e-5, grad=1e-4, stats=1e-5)
YARDSTICK = 4.0
NUDGES = (1e-6, -1e-6)
LR, WARMUP, MAX_NORM = 1e-3, 2, 1.0
N_ADAM = 3
ADAM_TOL = 1e-7
OBJECT = port_fat.FallingThingsObject.MustardBottle
ENVIRONMENTS = (port_fat.FallingThingsEnvironment.Kitchen0,
                port_fat.FallingThingsEnvironment.Temple3)
EMPTY = (1,)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def fat_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fat")
    write_square_fat_dataset(root, np.random.default_rng(0), 4, FRAME_H, FRAME_W,
                             environments=ENVIRONMENTS, max_objects=3, empty=EMPTY)
    return root


def datasets(root):
    """(JAX's reader, the port's) over every environment, as the CLIs
    build them."""
    jax_ds = jax_fat.FallingThingsDataset(
        root, jax_fat.FallingThingsVariant.SINGLE, list(jax_fat.FallingThingsEnvironment),
        objects=[jax_fat.FallingThingsObject[OBJECT.name]])
    port_ds = port_fat.FallingThingsDataset(
        root, port_fat.FallingThingsVariant.SINGLE, list(port_fat.FallingThingsEnvironment),
        objects=[OBJECT])
    return jax_ds, port_ds


def test_torch_fat_reader_and_collate_match_jax(fat_root):
    jax_ds, port_ds = datasets(fat_root)
    assert len(port_ds) == len(jax_ds) == 4 * len(ENVIRONMENTS)
    samples = []
    for i in range(len(port_ds)):
        got, want = port_ds[i], jax_ds[i]
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            assert g.dtype == w.dtype and np.array_equal(g, w), (i, f.name)
        samples.append(got)
    # The empty frame gives way to the next one.
    assert np.array_equal(port_ds[EMPTY[0]].img, port_ds[EMPTY[0] + 1].img)
    counts = [len(s.classifications) for s in samples]
    assert max(counts) > 1 and set(np.concatenate([s.classifications for s in samples])) == {
        port_fat.falling_things_object_ids[OBJECT.value]}
    assert port_ds[0].depth_map.max() > 0 and port_ds[0].seg_map.max() == 5

    for batch in (samples[:4], samples[4:]):
        got_img, got = train_yolo_pose.collate_fat(batch, H, W)
        want_img, want = jax_cli.collate_fat(batch, H, W)
        assert got_img.dtype == want_img.dtype and np.array_equal(got_img, want_img)
        for f in dataclasses.fields(want):
            g, w = getattr(got, f.name), getattr(want, f.name)
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
    # A later slot of the class takes its pixels: only the last slot shows.
    many = next(i for i, c in enumerate(counts) if c > 1)
    _, truth = train_yolo_pose.collate_fat([samples[many]], H, W)
    assert set(np.unique(truth.seg_map)) <= {counts[many] - 1, 255}


@pytest.fixture(scope="module")
def batch(fat_root):
    """The first batch of BATCH frames with objects, collated at 64x96."""
    _, port_ds = datasets(fat_root)
    return train_yolo_pose.collate_fat([port_ds[i] for i in (0, 2)], H, W)


def rel_l2(port, want):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30)


def jax_steps(img, truth):
    """JAX's own N_ADAM steps from the numpy weights, the CLI's ``loss_fn``
    and ``make_step`` restated: each step's raw losses, gradients and
    batch statistics, and the state after it (port names)."""
    model = JaxYoloPose(JAX_CFG)
    variables = random_variables(model, (1, H, W, 3), 0)
    jt = JaxTruth(**{f.name: jnp.asarray(getattr(truth, f.name))
                     for f in dataclasses.fields(truth)})

    def loss_fn(params, batch_stats):
        prediction, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                          jnp.asarray(img), train=True, mutable=["batch_stats"])
        losses = jax_yolo_pose_loss(prediction, jt, JAX_CFG)
        return losses.total, (losses, mutated["batch_stats"])

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    apply = jax.jit(lambda state, grads, stats: state.apply_gradients(grads=grads).replace(
        batch_stats=stats))
    state = JaxTrainState.create(apply_fn=model.apply, params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 tx=jax_warmup_adam(LR, WARMUP, MAX_NORM))
    steps = []
    for _ in range(N_ADAM):
        (_, (losses, stats)), grads = value_and_grad(state.params, state.batch_stats)
        state = apply(state, grads, stats)
        steps.append(dict(
            losses=jax.device_get(losses),
            grads=yolo_pose_state_dict_from_flax({"params": jax.device_get(grads),
                                                  "batch_stats": jax.device_get(stats)}),
            after=yolo_pose_state_dict_from_flax(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats}))))
    return yolo_pose_state_dict_from_flax(variables), steps


@pytest.fixture(scope="module")
def f32_setup(batch):
    img, truth = batch
    start, steps = jax_steps(img, truth)
    model = YoloPose(CFG, device="cpu")
    step = make_yolo_pose_train_step(CFG)
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    runs = []
    for nudge in (0.0,) + NUDGES:
        model.load_state_dict(start)
        # A clip that never bites leaves the raw gradients in .grad.
        state = TrainState(model, adam_with_clip(model.parameters(), LR, float("inf")))
        _, losses = step(state, x * (1 + nudge) if nudge else x, truth.to("cpu"))
        runs.append(dict(losses=losses,
                         grads={n: p.grad.clone() for n, p in model.named_parameters()},
                         stats={n: b.clone() for n, b in model.named_buffers()
                                if n.endswith(("running_mean", "running_var"))}))
    return dict(start=start, jax=steps, port=runs[0], nudged=runs[1:], model=model)


def test_torch_yolo_pose_train_step_f32_matches_jax(f32_setup, batch):
    want, port, nudged = f32_setup["jax"][0], f32_setup["port"], f32_setup["nudged"]

    def bar(base, get):
        return max(base, YARDSTICK * max(rel_l2(get(n), get(port)) for n in nudged))

    for field in LOSS_FIELDS:
        got, w = getattr(port["losses"], field), getattr(want["losses"], field)
        assert float(w) > 0, field
        err = rel_l2(got, w)
        assert err <= bar(BARS["loss"], lambda r: getattr(r["losses"], field)), (field, err)

    bad, zero = {}, []
    for name, g in port["grads"].items():
        w = want["grads"][name]
        if not w.any():
            assert not g.any(), name
            zero.append(name)
            continue
        err = rel_l2(g, w)
        if err > bar(BARS["grad"], lambda r: r["grads"][name]):
            bad[name] = err
    assert not bad, ("gradients", bad)
    model = f32_setup["model"]
    model.load_state_dict(f32_setup["start"])
    x = torch.from_numpy(batch[0]).permute(0, 3, 1, 2).contiguous()
    assert len(port["grads"]) == 143
    assert set(zero) == zero_by_construction(model, x, batch[1].to("cpu"))

    stats = port["stats"]
    assert len(stats) == 48
    for name in stats:
        err = rel_l2(stats[name], want["grads"][name])
        assert err <= bar(BARS["stats"], lambda r: r["stats"][name]), (name, err)


def test_torch_yolo_pose_warmup_adam_matches_optax(f32_setup):
    """The port's warm-up Adam fed JAX's own gradients, step after step,
    lands on optax's parameters; the first update moves nothing."""
    model, start = f32_setup["model"], f32_setup["start"]
    model.load_state_dict(start)
    optimizer = warmup_adam(model.parameters(), LR, WARMUP, MAX_NORM)
    for k, jax_step in enumerate(f32_setup["jax"]):
        for n, p in model.named_parameters():
            p.grad = jax_step["grads"][n].clone()
        optimizer.step()
        moved = False
        for name, p in model.named_parameters():
            torch.testing.assert_close(p.detach(), jax_step["after"][name], rtol=ADAM_TOL,
                                       atol=ADAM_TOL, msg=name)
            moved |= not torch.equal(p.detach(), start[name])
        assert moved == (k > 0), k
    assert optimizer.param_groups[0]["count"] == N_ADAM


def zero_by_construction(model, x, truth):
    """The parameters that no trained anchor reaches: FPN level 3 is the
    first downsample conv of level 2's output, level 4 the second's of
    level 3, so the downsample conv k has no gradient when no anchor of
    the levels from 3 + k on is trained (positive or OHEM's), and level
    2's output conv none when no anchor from level 2 on is.  The anchor
    sets come from the model's own training-mode forward (its running
    statistics kept)."""
    from tauv_vision_tpu_torch.ops.anchors import fpn_level_sizes

    buffers = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad(), model_mode(model, True):
        sets = match_anchor_sets(model(x), truth, CFG, 16)
    model.load_state_dict(buffers, strict=False)
    sizes = fpn_level_sizes(H, W, CFG.n_fpn_levels)
    starts = np.cumsum([0] + [h * w for h, w in sizes])
    trained = [bool(sets.selected[:, starts[i]:starts[i + 1]].any()) for i in range(len(sizes))]
    zero = set()
    if not any(trained[2:]):
        zero |= {f"fpn._prediction_layers.2.{leaf}" for leaf in ("weight", "bias")}
    for k in range(CFG.n_fpn_downsample_layers):
        if not any(trained[3 + k:]):
            zero |= {f"fpn._downsample_layers.{k}.{leaf}" for leaf in ("weight", "bias")}
    return zero


def test_torch_yolo_pose_train_step_bf16(batch):
    img, truth = batch
    model = YoloPose(CFG, dtype=torch.bfloat16, init="flax",
                     generator=torch.Generator().manual_seed(0), device="cpu").eval()
    state = TrainState(model, warmup_adam(model.parameters(), LR, WARMUP, MAX_NORM))
    x, truth = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(), truth.to("cpu")
    zero = zero_by_construction(model, x, truth)
    step = make_yolo_pose_train_step(CFG)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        step(state, x, truth)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, losses = step(state, x, truth)
    ranges = {e.key for e in prof.key_averages()}
    assert {train_steps.FORWARD, train_steps.LOSS, train_steps.OPTIMIZER} <= ranges
    for field in LOSS_FIELDS:
        v = float(getattr(losses, field))
        assert math.isfinite(v) and v > 0, (field, v)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert bool(p.grad.any()) != (name in zero), name
    # The step trained in training mode and gave every module its mode back.
    assert not any(m.training for m in model.modules())
    assert any(not torch.equal(b, torch.zeros_like(b)) and not torch.equal(b, torch.ones_like(b))
               for n, b in model.named_buffers() if n.endswith("running_mean"))


def test_torch_yolo_pose_cli_config_is_jax():
    assert dataclasses.asdict(train_yolo_pose.model_config) == dataclasses.asdict(
        jax_cli.model_config)
    assert train_yolo_pose.model_config == BENCH_YOLO_POSE.model
    assert train_yolo_pose.MAX_OBJECTS == jax_cli.MAX_OBJECTS


@pytest.fixture
def cli(monkeypatch):
    """The CLI's module-literal model config narrowed to SMALL (64x96)."""
    monkeypatch.setattr(train_yolo_pose, "model_config", CFG)
    return train_yolo_pose


def test_torch_train_yolo_pose_cli_trains(cli, fat_root, tmp_path):
    results = tmp_path / "run"
    state = cli.main(["--fat-root", str(fat_root), "--results-dir", str(results),
                      "--batch-size", "2", "--n-epochs", "2", "--epoch-n-batches", "3",
                      "--warmup-epochs", "1", "--watch-every", "2", "--no-figures"],
                     device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    assert state.model.dtype == torch.bfloat16 and state.step == 6
    with open(results / "metrics.jsonl") as fp:
        records = [json.loads(line) for line in fp]
    train = [r for r in records if "train/total" in r]
    watch = [r for r in records if "watch/global_grad_norm" in r]
    assert len(train) == 6 and [r["step"] for r in watch] == [0, 2, 4]
    assert all(math.isfinite(r[f"train/{f}"]) for r in train for f in LOSS_FIELDS)
    assert state.optimizer.param_groups[0]["warmup_steps"] == 3
    manager = CheckpointManager(results / "checkpoints")
    assert manager.all_steps() == [3]            # epoch 0 of a 5-epoch interval
    assert YoloPoseModelConfig.load(results / "checkpoints" / "model_config.json") == CFG
    fresh = YoloPose(CFG, dtype=torch.bfloat16, device="cpu")
    restored = manager.restore(TrainState(fresh, warmup_adam(fresh.parameters(), 1e-4, 3, 1.0)))
    saved = torch.load(results / "checkpoints" / "3" / "state.pt", weights_only=True)
    assert restored.step == 3 and restored.optimizer.param_groups[0]["count"] == 3
    assert all(torch.equal(v, saved["model"][k]) for k, v in fresh.state_dict().items())


def test_torch_train_yolo_pose_cli_raises_where_it_cannot_run(cli, tmp_path, monkeypatch):
    args = ["--fat-root", str(tmp_path), "--results-dir", str(tmp_path / "out")]
    with pytest.raises(NotImplementedError, match="no-figures"):
        cli.main(args, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args + ["--no-figures"])
