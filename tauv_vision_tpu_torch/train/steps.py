"""Train and eval steps of the CenterNet and the YOLACT (counterpart of
``tauv_vision_tpu/train/steps.py``), and YOLO-Pose's train step (the JAX
YOLO-Pose CLI's ``loss_fn`` and ``make_step``,
``scripts/train_yolo_pose.py``, single-device as that CLI is).

``mesh=`` (a ``parallel.mesh.Mesh`` of more than one rank) makes a step
data-parallel: each rank is given its host-local rows of the global
batch and runs the step; BatchNorm takes its batch statistics over the
mesh (``models.layers.data_parallel``), the losses their normalisers,
and after ``backward()`` the ranks' gradients and losses are summed by
one all-reduce of one flat buffer in the parameters' order, before the
watch statistics and the clipped Adam step.  Every rank then holds the
single-device step's gradients and losses of the global batch, and
takes the same optimizer step.  The model is the bare model (no
wrapper), so a data-parallel checkpoint loads in one process.  Without a
mesh, or with a mesh of one rank, a step is what it was before the mesh
existed.

``step(state, img, truth) -> (state, losses)``: img [B, 3, H, W] f32 and
the truth (``CenternetTruth.to``, ``YolactTruth.to``,
``YoloPoseTruth.to``) on the model's device.  A step sets the
model's mode for its own forward and gives the modules back the modes they
had, so a served net that shares the model is not left in training mode.
Training runs with autograd on; it raises inside ``torch.inference_mode``,
where no graph is recorded (the serving pipelines open one).  The train
step's forward and optimizer step are ``torch.profiler`` ranges
(``FORWARD``, ``OPTIMIZER``; the YOLACT's and YOLO-Pose's loss also
``LOSS``, inside ``FORWARD``), which a profile reads the step's split from (on the card
autograd runs the backward on a thread of its own, outside any range
opened here).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from tauv_vision_tpu_torch.configs.centernet import (
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfigSet,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import sow_dcn_offsets
from tauv_vision_tpu_torch.models.layers import data_parallel
from tauv_vision_tpu_torch.parallel.mesh import Mesh, parallel
from tauv_vision_tpu_torch.train.centernet_task import CenternetTruth, centernet_loss
from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig, YolactTrainConfig
from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig
from tauv_vision_tpu_torch.train.state import TrainState
from tauv_vision_tpu_torch.train.watch import watch_metrics
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth, yolact_loss
from tauv_vision_tpu_torch.train.yolo_pose_task import YoloPoseTruth, yolo_pose_loss


FORWARD = "train_step/forward"
LOSS = "train_step/loss"
OPTIMIZER = "train_step/optimizer"


def dcn_offset_penalty(offsets: Sequence[torch.Tensor], offset_range: float,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The mean squared excess of |offset| over ``offset_range``, over every
    offset of every DCN block's forward (``sow_dcn_offsets``); 0 when there
    are none.  Under a data ``mesh`` the mean is over the global batch's
    offsets: this rank's share."""
    if not offsets:
        return torch.zeros(())
    excess = sum(torch.sum(torch.square(torch.clamp_min(torch.abs(o.float()) - offset_range, 0.0)))
                 for o in offsets)
    count = sum(o.numel() for o in offsets)
    if parallel(mesh):
        count *= mesh.size    # every rank holds as many rows, so as many offsets
    return excess / count


def _data_parallel(model: nn.Module, mesh: Optional[Mesh]):
    return data_parallel(model, mesh) if parallel(mesh) else contextlib.nullcontext()


def _fields(losses):
    """(name, value as a tensor) of each field that is a sum of the ranks'
    shares under a mesh (a losses dataclass's ``NOT_ADDITIVE`` are not)."""
    skip = getattr(losses, "NOT_ADDITIVE", ())
    return [(f.name, torch.as_tensor(getattr(losses, f.name)))
            for f in dataclasses.fields(losses) if f.name not in skip]


@torch.no_grad()
def reduce_step(model: Optional[nn.Module], losses, mesh: Optional[Mesh]):
    """Sum the ranks' gradients of ``model`` (when given) and their loss
    shares over ``mesh`` in one all-reduce of one f32 buffer: each
    parameter's gradient in ``model.parameters()`` order (zeros where a
    rank has none), one flag a parameter counting the ranks that had one,
    then the losses.  A parameter no rank has a gradient for keeps None.
    Returns the global losses (detached); the identity without a mesh of
    more than one rank."""
    if not parallel(mesh):
        return losses
    params = [] if model is None else [p for p in model.parameters() if p.requires_grad]
    fields = _fields(losses)
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
         for p in params]
        + [torch.tensor([float(p.grad is not None) for p in params], device=mesh.device)]
        + [torch.stack([v.detach().float().to(mesh.device) for _, v in fields])])
    mesh.all_reduce_(flat)
    sums, start = [], 0
    for p in params:
        sums.append(flat[start:start + p.numel()].view_as(p))
        start += p.numel()
    for p, summed, flag in zip(params, sums, flat[start:start + len(params)].tolist()):
        p.grad = summed.to(p.dtype) if flag > 0 else None
    values = flat[start + len(params):]
    return dataclasses.replace(losses, **{
        name: values[i].to(v.dtype) for i, (name, v) in enumerate(fields)})


@contextlib.contextmanager
def model_mode(model: nn.Module, training: bool) -> Iterator[None]:
    """``model.train(training)`` inside the ``with``; every module's own
    mode afterwards."""
    modes = [(m, m.training) for m in model.modules()]
    model.train(training)
    try:
        yield
    finally:
        for m, mode in modes:
            m.training = mode


def make_centernet_train_step(
    model_config: CenternetModelConfig,
    train_config: CenternetTrainConfig,
    object_config: ObjectConfigSet,
    watch: bool = False,
    mesh: Optional[Mesh] = None,
):
    """One optimizer step on the loss of a batch: forward in training mode
    (batch statistics, the running ones updated), ``centernet_loss``, the
    DCN offset penalty where ``loss_lambda_dcn_offset`` > 0, backward and
    the optimizer's step (clipping included).  The losses come back
    detached, on the device.  ``watch``: the step returns (state, losses,
    ``watch_metrics`` of the parameters and raw gradients before the
    optimizer's step), as the JAX step built with ``watch=True`` does.
    ``mesh``: data-parallel over its ranks (the module docstring)."""
    reg = train_config.loss_lambda_dcn_offset
    reg_range = train_config.dcn_offset_range

    def step(state: TrainState, img: torch.Tensor, truth: CenternetTruth):
        if torch.is_inference_mode_enabled():
            raise RuntimeError("a train step cannot run inside torch.inference_mode")
        model, optimizer = state.model, state.optimizer
        sow = sow_dcn_offsets(model) if reg > 0 else contextlib.nullcontext([])
        with (torch.enable_grad(), model_mode(model, True), _data_parallel(model, mesh),
              sow as offsets):
            optimizer.zero_grad(set_to_none=True)
            with record_function(FORWARD):
                prediction = model(img)
                losses = centernet_loss(prediction, truth, model_config, train_config,
                                        object_config, mesh)
                if reg > 0:
                    penalty = dcn_offset_penalty(offsets, reg_range, mesh).to(
                        losses.total.device)
                    losses.dcn_offset = penalty
                    losses.total = losses.total + reg * penalty
            losses.total.backward()
        losses = reduce_step(model, losses, mesh)
        stats = watch_metrics(model) if watch else None
        with record_function(OPTIMIZER):
            optimizer.step()
        state.step += 1
        if watch:
            return state, losses.detach(), stats
        return state, losses.detach()

    return step


def make_centernet_eval_step(
    model_config: CenternetModelConfig,
    train_config: CenternetTrainConfig,
    object_config: ObjectConfigSet,
    mesh: Optional[Mesh] = None,
):
    """The losses of a batch in inference mode (running statistics), with
    no graph; under ``mesh``, those of the global batch on every rank."""

    def step(state: TrainState, img: torch.Tensor, truth: CenternetTruth):
        with torch.no_grad(), model_mode(state.model, False):
            prediction = state.model(img)
            losses = centernet_loss(prediction, truth, model_config, train_config,
                                    object_config, mesh).detach()
        return reduce_step(None, losses, mesh)

    return step


def _loss_train_step(loss_fn, watch: bool, mesh: Optional[Mesh] = None):
    """One optimizer step on ``loss_fn(prediction, truth)``: forward in
    training mode (batch statistics, the running ones updated), the loss,
    backward and the optimizer's step (clipping included).  The losses
    come back detached, on the device.  ``watch``: the step returns
    (state, losses, ``watch_metrics`` of the parameters and raw gradients
    before the optimizer's step).  ``mesh``: data-parallel over its ranks
    (the module docstring; ``loss_fn`` takes its normalisers over it)."""

    def step(state: TrainState, img: torch.Tensor, truth):
        if torch.is_inference_mode_enabled():
            raise RuntimeError("a train step cannot run inside torch.inference_mode")
        model, optimizer = state.model, state.optimizer
        with torch.enable_grad(), model_mode(model, True), _data_parallel(model, mesh):
            optimizer.zero_grad(set_to_none=True)
            with record_function(FORWARD):
                prediction = model(img)
                with record_function(LOSS):
                    losses = loss_fn(prediction, truth)
            losses.total.backward()
        losses = reduce_step(model, losses, mesh)
        stats = watch_metrics(model) if watch else None
        with record_function(OPTIMIZER):
            optimizer.step()
        state.step += 1
        if watch:
            return state, losses.detach(), stats
        return state, losses.detach()

    return step


def make_yolact_train_step(
    model_config: YolactModelConfig,
    train_config: YolactTrainConfig,
    watch: bool = False,
    mesh: Optional[Mesh] = None,
):
    """``_loss_train_step`` on ``yolact_loss`` (a ``YolactTruth``);
    ``mesh``: data-parallel over its ranks."""
    return _loss_train_step(
        lambda prediction, truth: yolact_loss(prediction, truth, model_config, train_config,
                                              mesh),
        watch, mesh)


def make_yolo_pose_train_step(
    model_config: YoloPoseModelConfig,
    watch: bool = False,
    max_positive_anchors: int = 16,
):
    """``_loss_train_step`` on ``yolo_pose_loss`` (a ``YoloPoseTruth``), as
    the JAX YOLO-Pose CLI's step; there is no eval step (the JAX CLI has
    none)."""
    def loss(prediction, truth: YoloPoseTruth):
        return yolo_pose_loss(prediction, truth, model_config, max_positive_anchors)

    return _loss_train_step(loss, watch)


def make_yolact_eval_step(model_config: YolactModelConfig, train_config: YolactTrainConfig,
                          mesh: Optional[Mesh] = None):
    """The YOLACT losses of a batch in inference mode (running
    statistics), with no graph; under ``mesh``, those of the global batch
    on every rank."""

    def step(state: TrainState, img: torch.Tensor, truth: YolactTruth):
        with torch.no_grad(), model_mode(state.model, False):
            prediction = state.model(img)
            losses = yolact_loss(prediction, truth, model_config, train_config, mesh).detach()
        return reduce_step(None, losses, mesh)

    return step
