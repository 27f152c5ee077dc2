"""Data-parallel training and serving in the port on spawned gloo ranks
(127.0.0.1, one torch thread each), against the JAX package's
single-device step and the port's own single-process step.

A DP step on N ranks is the single-device step on the global batch: each
rank gets its rows, BatchNorm takes its statistics over the mesh, the
losses their normalisers, and the ranks' gradients are summed.  Each job
runs through ``scripts/dryrun_multichip``'s ``TrainJob`` / ``ServeJob``
(``rank_jobs`` in the ranks, ``run`` in this process), so a spawned rank
imports the port only.

- (a) The custom ``Centernet`` at ``tests/distributed_worker.py``'s
  configuration (32x32, heights (1,), channels (8, 8), its train config
  and batch of 4, seed 123) on 2 ranks: every loss term within 1e-4
  relative of JAX's single-device loss on the global batch (JAX's own
  DP bar, ``tests/test_distributed.py``) and within 1e-5 of the port's
  single-process step; every rank returns the same losses.
- (b) The same net on 4 ranks at global batch 8, rank 2's two rows
  without objects (noise images, no truth): the same bars, with the
  object count, the focal loss's peak count and ``avg_size_error`` taken
  over the global batch while one rank counts none.
- (c) The dryrun's ResNet-18 YOLACT (128x128) on 2 ranks at global batch
  4, rank 1's rows without objects (no positive anchor there): the same
  bars.
- The summed gradients and the BatchNorm running statistics of (a)-(c)
  are held to the single-process step's by the yardstick of
  ``test_torch_train_step.py``: relative L2 within the larger of 1e-4
  (gradients) or 1e-5 (statistics) and 4x the single-process step's own
  move, measured in the same run.  The move is the largest of three:
  the input scaled by 1 + 1e-6; the global batch's rows in reverse
  order; and the convolutions on torch's own CPU kernels instead of
  oneDNN's.  The last two change nothing but rounding: the order in
  which BatchNorm and the losses sum over the rows, and the order in
  which a conv sums, which is what a DP step changes (its ranks sum over
  their own rows, and convolve fewer rows, where oneDNN may block
  another way).  The input scale alone misses it where a BatchNorm right
  after the first conv divides the scale out (the ResNet trunk): on the
  YOLACT the reversed rows move the protonet's gradients by ~4e-4 (its
  layers before the second upsample), the input scale by ~4e-6, and DP
  lands ~3e-4 away.  A conv bias before a BatchNorm on batch statistics has a
  gradient of 0 in exact arithmetic: it is held by its size (below 1e-4
  of its weight's gradient, in both).
- (e) DP inference through ``make_centernet_pipeline(mesh=)`` (the custom
  net of ``tests/test_dp_serving.py``, 64x64, 8 frames of 80x80) and
  ``make_yolact_pipeline(mesh=)`` (the dryrun's YOLACT, 4 frames of
  144x160) on 2 ranks: every rank gets the global batch's detections,
  100% matched to the single-process pipeline's with every p95 within
  1e-5 (here they are equal).
"""

import dataclasses
import functools
import types
import warnings
from math import pi

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centernet import Centernet as JaxCenternet
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.train.centernet_task import CenternetTruth as JaxTruth
from tauv_vision_tpu.train.centernet_task import centernet_loss as jax_centernet_loss
from tauv_vision_tpu.train.yolact_task import YolactTruth as JaxYolactTruth
from tauv_vision_tpu.train.yolact_task import yolact_loss as jax_yolact_loss
from tauv_vision_tpu_torch.configs import (
    AngleConfig,
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfig,
    ObjectConfigSet,
)
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centernet import Centernet
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.parallel.distributed import spawn
from tauv_vision_tpu_torch.scripts.dryrun_multichip import (
    ServeJob,
    TrainJob,
    rank_jobs,
    run,
    yolact_batch,
    yolact_configs,
)
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.pipeline import DecodeKnobs
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth, match_anchors
from tauv_vision_tpu_torch.weights import (
    centernet_state_dict_from_flax,
    yolact_state_dict_from_flax,
)
from torch_parity import (
    jax_centernet_config,
    jax_object_config,
    jax_train_config,
    jax_yolact_config,
    jax_yolact_train_config,
    random_variables,
    torch_threads,
)

JAX_RTOL = 1e-4      # JAX's own DP bar (tests/test_distributed.py)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_TOL = 1e-5
YARDSTICK = 4.0
NUDGE = 1 + 1e-6
DECODE_P95 = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rel_l2(port, want):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30)


# ---- the configurations ---------------------------------------------------

def worker_configs(batch):
    """tests/distributed_worker.py's object, model and train configs, at
    global batch ``batch``."""
    oc = ObjectConfigSet(configs=(ObjectConfig(
        id="square", yaw=AngleConfig(train=False, modulo=2 * pi),
        pitch=AngleConfig(train=False, modulo=2 * pi),
        roll=AngleConfig(train=False, modulo=2 * pi),
        train_depth=False, train_keypoints=False, keypoints=None),))
    mc = CenternetModelConfig(in_h=32, in_w=32, backbone_heights=(1,), backbone_channels=(8, 8),
                              downsamples=2, angle_bin_overlap=pi / 3)
    tc = CenternetTrainConfig(
        lr=1e-3, batch_size=batch, n_batches=1, n_epochs=1, heatmap_focal_loss_a=2.0,
        heatmap_focal_loss_b=4.0, heatmap_sigma_factor=0.1, keypoint_heatmap_sigma=1.0,
        keypoint_affinity_sigma=1.0, loss_lambda_keypoint_heatmap=1.0,
        loss_lambda_keypoint_affinity=1.0, loss_lambda_size=0.1, loss_lambda_offset=1.0,
        loss_lambda_angle=1.0, loss_lambda_depth=1.0, max_objects=2, max_keypoints=2)
    return oc, mc, tc


def without_objects(img, truth, rows, seed):
    """The batch with ``rows`` made empty: noise images, no truth."""
    img = img.copy()
    img[rows] = np.random.default_rng(seed).uniform(0, 0.3, img[rows].shape).astype(img.dtype)
    changes = {}
    for f in dataclasses.fields(truth):
        value = getattr(truth, f.name)
        if value is not None:
            value = np.array(value)
            value[rows] = 0
            changes[f.name] = value
    return img, dataclasses.replace(truth, **changes)


def centernet_job(name, batch, empty_rows=()):
    """A TrainJob of the custom Centernet and JAX's losses of the same
    weights on the same global batch."""
    oc, mc, tc = worker_configs(batch)
    img, truth = generate_square_batch(np.random.default_rng(123), batch, SquareDatasetConfig(
        in_h=32, in_w=32, max_objects=2, min_side=6, max_side=12, rotate=False))
    if empty_rows:
        img, truth = without_objects(img, truth, list(empty_rows), seed=batch)
    jax_oc, jax_mc, jax_tc = jax_object_config(oc), jax_centernet_config(mc), jax_train_config(tc)
    jax_model = JaxCenternet(object_config=jax_oc, backbone_heights=mc.backbone_heights,
                             backbone_channels=mc.backbone_channels, downsamples=mc.downsamples)
    variables = random_variables(jax_model, (1, 32, 32, 3), 0)
    jax_truth = JaxTruth(**{f.name: None if getattr(truth, f.name) is None
                            else jnp.asarray(getattr(truth, f.name))
                            for f in dataclasses.fields(truth)})

    @jax.jit
    def loss(variables, img):
        prediction, _ = jax_model.apply(variables, img, train=True, mutable=["batch_stats"])
        return jax_centernet_loss(prediction, jax_truth, jax_mc, jax_tc, jax_oc)

    want = jax.device_get(loss(variables, jnp.asarray(img)))
    build = functools.partial(Centernet, oc, mc.backbone_heights, mc.backbone_channels,
                              mc.downsamples)
    job = TrainJob(name, "centernet", build, centernet_state_dict_from_flax(variables),
                   (mc, tc, oc), img, truth, lr=tc.lr, grads=True)
    return job, want


def yolact_job(name, batch, empty_rows):
    mc, tc = yolact_configs(batch)
    img, truth = yolact_batch(batch)
    truth = dataclasses.replace(truth, valid=truth.valid.copy(), seg_map=truth.seg_map.copy())
    truth.valid[list(empty_rows)] = False
    truth.seg_map[list(empty_rows)] = 255
    jcfg, jtc = jax_yolact_config(mc), jax_yolact_train_config(tc)
    jax_model = JaxYolact(jcfg)
    variables = random_variables(jax_model, (1, mc.in_h, mc.in_w, 3), 0)
    jax_truth = JaxYolactTruth(**{f.name: jnp.asarray(getattr(truth, f.name))
                                  for f in dataclasses.fields(truth)})

    @jax.jit
    def loss(variables, img):
        prediction, _ = jax_model.apply(variables, img, train=True, mutable=["batch_stats"])
        return jax_yolact_loss(prediction, jax_truth, jcfg, jtc)

    want = jax.device_get(loss(variables, jnp.asarray(img)))
    job = TrainJob(name, "yolact", functools.partial(Yolact, mc),
                   yolact_state_dict_from_flax(variables), (mc, tc), img, truth, lr=tc.lr,
                   max_norm=tc.grad_max_norm, grads=True)
    return job, want


def serve_jobs():
    oc, mc, _ = worker_configs(8)
    mc = dataclasses.replace(mc, in_h=64, in_w=64)
    cn = functools.partial(Centernet, oc, mc.backbone_heights, mc.backbone_channels,
                           mc.downsamples)
    cn_weights = cn(device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    ymc, _ = yolact_configs(4)
    yl = functools.partial(Yolact, ymc)
    yl_weights = yl(device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    rng = np.random.default_rng(0)
    return [
        ServeJob("centernet_serve", "centernet", cn, cn_weights, mc,
                 rng.integers(0, 256, (8, 80, 80, 3), dtype=np.uint8),
                 DecodeKnobs(n_detections=4, score_threshold=0.0)),
        ServeJob("yolact_serve", "yolact", yl, yl_weights, ymc,
                 rng.integers(0, 256, (4, 144, 160, 3), dtype=np.uint8),
                 DecodeKnobs(top_k=8, confidence_threshold=0.05)),
    ]


# ---- the runs -------------------------------------------------------------

def reversed_rows(job):
    truth = dataclasses.replace(job.truth, **{
        f.name: np.asarray(getattr(job.truth, f.name))[::-1].copy()
        for f in dataclasses.fields(job.truth) if getattr(job.truth, f.name) is not None})
    return dataclasses.replace(job, img=job.img[::-1].copy(), truth=truth)


def single(job):
    """The single-process step on the global batch, and the same step
    moved as the yardstick moves it (input x NUDGE, rows reversed, convs
    off oneDNN)."""
    moved = [run(dataclasses.replace(job, img=job.img * NUDGE), None, "cpu"),
             run(reversed_rows(job), None, "cpu")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # oneDNN's TF32 setting, for Intel GPUs only
        with torch.backends.mkldnn.flags(enabled=False):
            moved.append(run(job, None, "cpu"))
    return run(job, None, "cpu"), moved


@pytest.fixture(scope="module")
def two_ranks():
    cn, cn_want = centernet_job("centernet", 4)
    yl, yl_want = yolact_job("yolact", 4, empty_rows=(2, 3))
    serve = serve_jobs()
    jobs = [cn, yl] + serve
    ranks = spawn(rank_jobs, 2, jobs)
    return {
        "centernet": (cn, cn_want, [r[0] for r in ranks], single(cn)),
        "yolact": (yl, yl_want, [r[1] for r in ranks], single(yl)),
        "serve": [(job, [r[2 + i] for r in ranks], run(job, None, "cpu"))
                  for i, job in enumerate(serve)],
    }


@pytest.fixture(scope="module")
def four_ranks():
    job, want = centernet_job("centernet_empty_rank", 8, empty_rows=(4, 5))
    ranks = spawn(rank_jobs, 4, [job])
    return job, want, [r[0] for r in ranks], single(job)


# ---- the checks -----------------------------------------------------------

def bar(base, want, moved):
    """The larger of ``base`` and YARDSTICK times the largest of the
    single-process step's own moves."""
    return max([base] + [YARDSTICK * rel_l2(m, want) for m in moved])


def assert_losses(want_jax, ranks, one, moved):
    got = ranks[0]["losses"]
    for r in ranks[1:]:
        assert r["losses"] == got
    for name, value in got.items():
        w_one = one["losses"][name]
        assert rel_l2(value, w_one) <= bar(LOSS_RTOL, w_one,
                                           [m["losses"][name] for m in moved]), name
        if want_jax is None:
            continue
        w = np.asarray(getattr(want_jax, name))
        if not w.any():
            assert value == 0, name
            continue
        assert rel_l2(value, w) <= JAX_RTOL, (name, value, float(w))


def assert_grads_and_stats(dp, one, moved):
    grads, want = dp["grads"], one["grads"]
    assert set(grads) == set(want)
    bad, held = {}, 0
    for name, g in grads.items():
        w = want[name]
        weight = name[:-len("bias")] + "weight"
        if name.endswith(".bias") and weight in want and (
                np.linalg.norm(w) <= GRAD_RTOL * np.linalg.norm(want[weight])):
            assert np.linalg.norm(g) <= GRAD_RTOL * np.linalg.norm(grads[weight]), name
            continue
        if not w.any():
            assert not g.any(), name
            continue
        held += 1
        err = rel_l2(g, w)
        if err > bar(GRAD_RTOL, w, [m["grads"][name] for m in moved]):
            bad[name] = err
    assert held > 10 and not bad, bad
    assert set(dp["buffers"]) == set(one["buffers"]) and dp["buffers"]
    for name, b in dp["buffers"].items():
        err = rel_l2(b, one["buffers"][name])
        assert err <= bar(STATS_TOL, one["buffers"][name],
                          [m["buffers"][name] for m in moved]), (name, err)


def test_torch_dp_centernet_two_ranks(two_ranks):
    job, want, ranks, (one, moved) = two_ranks["centernet"]
    assert want.heatmap > 0 and want.size > 0 and want.offset > 0
    assert_losses(want, ranks, one, moved)
    assert_grads_and_stats(ranks[0], one, moved)


def test_torch_dp_centernet_four_ranks_one_without_objects(four_ranks):
    job, want, ranks, (one, moved) = four_ranks
    per_rank = job.truth.valid.reshape(4, -1).sum(axis=1)
    assert per_rank[2] == 0 and (per_rank[[0, 1, 3]] > 0).all()
    assert np.isfinite(ranks[0]["losses"]["avg_size_error"])
    assert_losses(want, ranks, one, moved)
    assert_grads_and_stats(ranks[0], one, moved)


def test_torch_dp_yolact_two_ranks_one_without_positives(two_ranks):
    job, want, ranks, (one, moved) = two_ranks["yolact"]
    model = job.build(device="cpu")
    model.load_state_dict(job.state_dict)
    with torch.no_grad():
        prediction = model(torch.from_numpy(job.img).permute(0, 3, 1, 2).contiguous())
        sets = match_anchors(prediction, YolactTruth(**{
            f.name: torch.as_tensor(getattr(job.truth, f.name))
            for f in dataclasses.fields(job.truth)}), *job.configs)
    positives = sets.positive.sum(dim=1).tolist()
    assert positives[2:] == [0, 0] and min(positives[:2]) > 0
    assert_losses(want, ranks, one, moved)
    assert_grads_and_stats(ranks[0], one, moved)


def as_detections(arrays):
    return types.SimpleNamespace(**arrays)


@pytest.mark.parametrize("which", [0, 1])
def test_torch_dp_pipelines_match_one_process(two_ranks, which):
    job, ranks, one = two_ranks["serve"][which]
    want = one["detections"]
    assert want["score"].shape[0] == job.frames.shape[0]
    for r in ranks:
        got = r["detections"]
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == want[name].shape and got[name].dtype == want[name].dtype
        deltas = detection_deltas(as_detections(got), as_detections(want))
        assert deltas["total"] > 0 and deltas["matched_fraction"] == 1.0, deltas
        for key, value in deltas.items():
            if key.endswith("_p95"):
                assert value <= DECODE_P95, (key, value)
