"""Data parallelism end to end on N ranks (counterpart of
``__graft_entry__.dryrun_multichip``, without its 2-D mesh).

  python -m tauv_vision_tpu_torch.scripts.dryrun_multichip --ranks N [--device cpu]

spawns N gloo ranks (``parallel.distributed.spawn``; on the card they
share ``cuda:0``) and runs, each at global batch N:

- one train step of the plain-IDA ``CenterpointDLA34`` at 64x64 (the
  JAX dryrun's flagship: one class, yaw and depth trained);
- one of the DCN DLA-34 with the offset penalty on
  (``loss_lambda_dcn_offset`` 1, ``dcn_offset_range`` 1);
- one of the dryrun's ResNet-18 YOLACT at 128x128;
- DP inference through ``make_centernet_pipeline(mesh=)`` on the
  plain DLA-34.

Each is held against the same job run in this process on the global
batch: the losses within ``LOSS_RTOL`` relative, the decoded detections'
checksum within ``CHECKSUM_ATOL`` (JAX's check).  It prints
``dryrun_multichip(N): ok, dla34_dp_loss=..., dla34_dcn_dp_loss=...,
yolact_dp_loss=..., dp_infer_checksum=... (single-device ...)``.

The jobs (``TrainJob``, ``ServeJob``) and the rank function
(``rank_jobs``) are what the tests and ``chip_smoke.py`` drive too: a
spawned rank imports this module, never JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from math import pi
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    AngleConfig,
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfig,
    ObjectConfigSet,
    YolactModelConfig,
    YolactTrainConfig,
)
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.parallel.distributed import spawn
from tauv_vision_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch
from tauv_vision_tpu_torch.serving.pipeline import (
    DecodeKnobs,
    make_centernet_pipeline,
    make_yolact_pipeline,
)
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import (
    make_centernet_train_step,
    make_yolact_train_step,
)
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth

LOSS_RTOL = 1e-4        # JAX's own DP bar (tests/test_distributed.py)
CHECKSUM_ATOL = 1e-3    # JAX's dryrun's
IN_HW = 64
YOLACT_HW = 128


@dataclasses.dataclass
class TrainJob:
    """One train step of a model from given weights on a global batch.

    ``build(device=...)`` makes the model (a ``functools.partial`` of a
    port model class, so that it pickles); ``state_dict`` its weights, on
    the CPU; ``configs`` the step factory's (``(mc, tc, oc)`` for "centernet",
    ``(mc, tc)`` for "yolact"); ``img`` the global NHWC f32 batch and
    ``truth`` its numpy truth.  ``grads``: the result holds the first
    step's gradients (before the optimizer's step, summed over the ranks)
    and the BatchNorm statistics after it.  ``exact``: TF32 off and cuDNN
    deterministic while the job runs.  ``time_iters`` > 0 times that many
    more steps, then as many with each collective timed."""

    name: str
    kind: str
    build: Callable
    state_dict: dict
    configs: tuple
    img: np.ndarray
    truth: Any
    lr: float = 1e-3
    max_norm: float = 1.0
    grads: bool = False
    exact: bool = False
    time_iters: int = 0


@dataclasses.dataclass
class ServeJob:
    """One request of a serving pipeline on a global batch of uint8
    frames: ``kind`` "centernet" or "yolact", the model as in
    ``TrainJob``, served in eval mode in f32, decoded with ``knobs``;
    ``exact`` and ``time_iters`` as ``TrainJob``'s."""

    name: str
    kind: str
    build: Callable
    state_dict: dict
    model_config: Any
    frames: np.ndarray
    knobs: DecodeKnobs = DecodeKnobs()
    exact: bool = False
    time_iters: int = 0


@contextlib.contextmanager
def exact_math(on: bool):
    """TF32 off and cuDNN deterministic inside the ``with`` when ``on``;
    the settings as they were afterwards."""
    keys = ("matmul", "cudnn_tf32", "deterministic", "benchmark")
    before = dict(zip(keys, (torch.backends.cuda.matmul.allow_tf32,
                             torch.backends.cudnn.allow_tf32,
                             torch.backends.cudnn.deterministic,
                             torch.backends.cudnn.benchmark)))
    if on:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before["matmul"]
        torch.backends.cudnn.allow_tf32 = before["cudnn_tf32"]
        torch.backends.cudnn.deterministic = before["deterministic"]
        torch.backends.cudnn.benchmark = before["benchmark"]


def _local(batch, mesh: Optional[Mesh], device):
    """This rank's rows of a global numpy batch on its device, or the whole
    batch on ``device``."""
    if mesh is not None:
        return shard_batch(batch, mesh)
    if dataclasses.is_dataclass(batch):
        return batch.to(device)
    return torch.as_tensor(batch).to(device)


def _host_rows(x: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """This rank's rows of a global numpy batch, on the host."""
    if mesh is None:
        return x
    per = x.shape[0] // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> dict:
    return {"kernels": dict(kernels.LAUNCHES), "entries": dict(kernels.ENTRY_LAUNCHES),
            "variants": dict(kernels.VARIANT_LAUNCHES)}


def _model(job, device):
    model = job.build(device=device)
    model.load_state_dict(job.state_dict)
    return model


def run_train(job: TrainJob, mesh: Optional[Mesh] = None, device="cpu") -> dict:
    """``job``'s step, data-parallel over ``mesh`` (each rank given its rows
    of the global batch) or on the whole batch on ``device``.  Returns the
    global losses (floats), the kernel launches of the step, and what
    ``job`` asks for."""
    device = mesh.device if mesh is not None else torch.device(device)
    lead = mesh is None or mesh.rank == 0
    with exact_math(job.exact):
        model = _model(job, device)
        if mesh is not None:
            replicate(model, mesh)
        factory = {"centernet": make_centernet_train_step,
                   "yolact": make_yolact_train_step}[job.kind]
        step = factory(*job.configs, mesh=mesh)
        state = TrainState(model, adam_with_clip(model.parameters(), job.lr, job.max_norm))
        raw = {}
        # The first step's gradients only: the timed steps below step on.
        hook = state.optimizer.register_step_pre_hook(lambda *_: raw.update(
            {n: p.grad.detach().float().cpu().numpy().copy()
             for n, p in model.named_parameters() if p.grad is not None}
            if job.grads and lead else {}))
        img = _local(job.img, mesh, device).permute(0, 3, 1, 2).contiguous()
        truth = _local(job.truth, mesh, device)
        _sync(device)
        kernels.reset_launch_counts()
        state, losses = step(state, img, truth)
        hook.remove()
        _sync(device)
        out = {"losses": {f.name: float(getattr(losses, f.name))
                          for f in dataclasses.fields(losses)},
               "launches": _launches()}
        if job.grads and lead:
            out["grads"] = raw
            out["buffers"] = {n: b.detach().float().cpu().numpy().copy()
                              for n, b in model.named_buffers()
                              if n.endswith(("running_mean", "running_var"))}
        if job.time_iters:
            out.update(_timed(lambda: step(state, img, truth), job.time_iters, mesh, device))
    return out


def _timed(fn, iters: int, mesh: Optional[Mesh], device) -> dict:
    """ms a call of ``fn`` over ``iters`` calls after one warm-up; under a
    mesh, then as many with every collective timed: the collectives' ms a
    call and their share of that run's time, their calls and bytes a
    call."""
    fn()
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    out = {"ms": (time.perf_counter() - start) * 1e3 / iters}
    if mesh is not None:
        mesh.stats.reset()
        mesh.stats.timed = True
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        timed_ms = (time.perf_counter() - start) * 1e3 / iters
        mesh.stats.timed = False
        out.update(timed_ms=timed_ms, collective_ms=mesh.stats.seconds * 1e3 / iters,
                   collective_share=mesh.stats.seconds * 1e3 / iters / timed_ms,
                   collective_calls=mesh.stats.calls / iters,
                   collective_bytes=mesh.stats.bytes / iters)
    return out


def detections_numpy(detections) -> dict:
    """A detections dataclass as {field: numpy array} (None fields left
    out)."""
    return {f.name: getattr(detections, f.name).cpu().numpy()
            for f in dataclasses.fields(detections) if getattr(detections, f.name) is not None}


def run_serve(job: ServeJob, mesh: Optional[Mesh] = None, device="cpu") -> dict:
    """``job``'s request, each rank serving its frames of the global batch
    over ``mesh``, or the whole batch on ``device``.  Returns the global
    detections (numpy, on every rank) and the kernel launches of the
    request."""
    device = mesh.device if mesh is not None else torch.device(device)
    with exact_math(job.exact):
        model = _model(job, device).eval()
        if mesh is not None:
            replicate(model, mesh)
        make = {"centernet": make_centernet_pipeline, "yolact": make_yolact_pipeline}[job.kind]
        pipe = make(model, job.model_config, device, job.knobs, mesh=mesh)
        frames = torch.from_numpy(np.ascontiguousarray(_host_rows(job.frames, mesh)))
        _sync(device)
        kernels.reset_launch_counts()
        detections = pipe(frames)
        _sync(device)
        out = {"detections": detections_numpy(detections), "launches": _launches()}
        if job.time_iters:
            out.update(_timed(lambda: pipe(frames), job.time_iters, mesh, device))
    return out


def run(job, mesh: Optional[Mesh] = None, device="cpu") -> dict:
    return (run_train if isinstance(job, TrainJob) else run_serve)(job, mesh, device)


def rank_jobs(mesh: Mesh, jobs: List) -> List[dict]:
    """A spawned rank's work (``parallel.distributed.spawn``): every job of
    ``jobs`` in turn over ``mesh``, each result with its wall ``seconds``
    (the model's build included)."""
    out = []
    for job in jobs:
        start = time.perf_counter()
        result = run(job, mesh)
        result["seconds"] = time.perf_counter() - start
        out.append(result)
    return out


# ---- the dryrun's configurations (``__graft_entry__.py``) ----------------


def flagship_configs(batch: int):
    """(object, model and train configs) of the JAX dryrun's DLA-34 at
    64x64 and global batch ``batch``."""
    oc = ObjectConfigSet(configs=(ObjectConfig(
        id="torpedo_24", yaw=AngleConfig(train=True, modulo=2 * pi),
        pitch=AngleConfig(train=False, modulo=2 * pi),
        roll=AngleConfig(train=False, modulo=2 * pi),
        train_depth=True, train_keypoints=False, keypoints=None),))
    mc = CenternetModelConfig(in_h=IN_HW, in_w=IN_HW, backbone_heights=(2, 2, 2, 2, 2),
                              backbone_channels=(128,) * 6, downsamples=2,
                              angle_bin_overlap=pi / 3)
    tc = CenternetTrainConfig(
        lr=1e-4, batch_size=batch, n_batches=0, n_epochs=1, heatmap_focal_loss_a=2.0,
        heatmap_focal_loss_b=4.0, heatmap_sigma_factor=0.1, keypoint_heatmap_sigma=2.0,
        keypoint_affinity_sigma=2.0, loss_lambda_keypoint_heatmap=1.0,
        loss_lambda_keypoint_affinity=0.01, loss_lambda_size=0.1, loss_lambda_offset=0.1,
        loss_lambda_angle=0.1, loss_lambda_depth=0.1, max_objects=2)
    return oc, mc, tc


def yolact_configs(batch: int):
    """The JAX dryrun's ResNet-18 YOLACT at 128x128, global batch
    ``batch``."""
    mc = YolactModelConfig(
        in_w=YOLACT_HW, in_h=YOLACT_HW, feature_depth=64, n_classes=2, n_prototype_masks=8,
        n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
        n_prediction_head_layers=1, n_classification_layers=0, n_box_layers=0,
        n_mask_layers=0, n_fpn_downsample_layers=2,
        anchor_scales=(24, 48, 96, 192, 384), anchor_aspect_ratios=(1.0,),
        box_variances=(0.1, 0.2), iou_pos_threshold=0.4, iou_neg_threshold=0.3,
        negative_example_ratio=3)
    tc = YolactTrainConfig(lr=1e-3, momentum=0.9, weight_decay=0.0, grad_max_norm=1.0,
                           n_epochs=1, batch_size=batch, epoch_n_batches=1, max_objects=2,
                           max_positive_anchors=64)
    return mc, tc


def yolact_batch(batch: int, seed: int = 1):
    """The JAX dryrun's YOLACT batch: uniform images, two squares of class
    1 in every sample."""
    img = np.random.default_rng(seed).uniform(
        0, 1, (batch, YOLACT_HW, YOLACT_HW, 3)).astype(np.float32)
    box = np.asarray([[0.4, 0.4, 0.3, 0.3], [0.7, 0.7, 0.2, 0.2]], np.float32)
    seg = np.full((YOLACT_HW, YOLACT_HW), 255, np.int32)
    seg[32:70, 32:70] = 0
    seg[77:102, 77:102] = 1
    truth = YolactTruth(valid=np.ones((batch, 2), bool),
                        classification=np.ones((batch, 2), np.int32),
                        box=np.tile(box[None], (batch, 1, 1)),
                        seg_map=np.tile(seg[None], (batch, 1, 1)),
                        img_valid=np.ones((batch, YOLACT_HW, YOLACT_HW), bool))
    return img, truth


def _weights(build, seed: int) -> dict:
    """A model's weights drawn on the CPU from ``seed`` (the flax
    initialisers)."""
    model = build(device="cpu", generator=torch.Generator().manual_seed(seed))
    return {k: v.clone() for k, v in model.state_dict().items()}


def dryrun_jobs(n: int):
    """The dryrun's four jobs at global batch ``n``."""
    import functools

    oc, mc, tc = flagship_configs(n)
    img, truth = generate_square_batch(np.random.default_rng(0), n,
                                       SquareDatasetConfig(in_h=IN_HW, in_w=IN_HW, max_objects=2))
    truth = dataclasses.replace(truth, depth=np.ones_like(truth.depth))

    def dla(deform):
        return functools.partial(CenterpointDLA34, oc, deform=deform, init="flax")

    plain = dla(False)
    dcn = dla(True)
    ymc, ytc = yolact_configs(n)
    yolact = functools.partial(Yolact, ymc, init="flax")
    yimg, ytruth = yolact_batch(n)
    plain_weights = _weights(plain, 0)
    dcn_tc = dataclasses.replace(tc, loss_lambda_dcn_offset=1.0, dcn_offset_range=1.0)
    frames = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    # exact: the card's convs off TF32, as the CPU's f32 (LOSS_RTOL is an f32 bar).
    return [
        TrainJob("dla34_dp_loss", "centernet", plain, plain_weights, (mc, tc, oc), img, truth,
                 lr=tc.lr, exact=True),
        TrainJob("dla34_dcn_dp_loss", "centernet", dcn, _weights(dcn, 0), (mc, dcn_tc, oc),
                 img, truth, lr=tc.lr, exact=True),
        TrainJob("yolact_dp_loss", "yolact", yolact, _weights(yolact, 0), (ymc, ytc), yimg,
                 ytruth, lr=ytc.lr, max_norm=ytc.grad_max_norm, exact=True),
        ServeJob("dp_infer", "centernet", plain, plain_weights, mc, frames,
                 DecodeKnobs(n_detections=4, score_threshold=0.0), exact=True),
    ]


def checksum(detections: dict) -> float:
    """|score| + |y| + |x| summed over every slot (JAX's checksum)."""
    return float(sum(np.abs(detections[k]).astype(np.float64).sum()
                     for k in ("score", "y", "x")))


def dryrun(n: int, device: str = "cuda", grads: bool = False) -> dict:
    """Run the jobs over ``n`` spawned gloo ranks and in this process;
    raises where a result is outside its bar.  Returns {"dp": rank 0's
    results, "single": this process's, "jobs": the jobs, "line": the ok
    line}; ``grads``: the train jobs' results also hold their gradients
    and BatchNorm statistics (``TrainJob.grads``)."""
    jobs = [dataclasses.replace(job, grads=True) if grads and isinstance(job, TrainJob) else job
            for job in dryrun_jobs(n)]
    if device == "cuda":
        kernels.build()   # once, before the ranks load it
    dp = spawn(rank_jobs, n, jobs, device=device)[0]
    single = [run(job, None, device) for job in jobs]
    values = {}
    for job, got, want in zip(jobs, dp, single):
        if isinstance(job, TrainJob):
            g, w = got["losses"]["total"], want["losses"]["total"]
            if not (np.isfinite(g) and abs(g - w) <= LOSS_RTOL * abs(w)):
                raise RuntimeError(f"{job.name}: DP {g} against one process {w}")
            values[job.name] = g
        else:
            g, w = checksum(got["detections"]), checksum(want["detections"])
            if not (np.isfinite(g) and abs(g - w) < CHECKSUM_ATOL):
                raise RuntimeError(f"{job.name}: DP checksum {g} against one process {w}")
            values["checksum"], values["single_checksum"] = g, w
    line = (f"dryrun_multichip({n}): ok, dla34_dp_loss={values['dla34_dp_loss']:.4f}, "
            f"dla34_dcn_dp_loss={values['dla34_dcn_dp_loss']:.4f}, "
            f"yolact_dp_loss={values['yolact_dp_loss']:.4f}, "
            f"dp_infer_checksum={values['checksum']:.4f} "
            f"(single-device {values['single_checksum']:.4f})")
    return {"dp": dp, "single": single, "jobs": jobs, "line": line}


def main(argv=None, grads: bool = False) -> dict:
    """Parse ``argv``, run ``dryrun`` and print its ok line; returns its
    result (``grads`` as ``dryrun``'s)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=8)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    result = dryrun(args.ranks, args.device, grads)
    print(result["line"], flush=True)
    return result


if __name__ == "__main__":
    main()
