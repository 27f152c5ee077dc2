"""Train and eval steps of the CenterNet and the YOLACT (counterpart of
``tauv_vision_tpu/train/steps.py``, without the mesh: data-parallel
training comes later), and YOLO-Pose's train step (the JAX YOLO-Pose
CLI's ``loss_fn`` and ``make_step``, ``scripts/train_yolo_pose.py``).

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
from typing import Iterator, Sequence

import torch
from torch import nn
from torch.profiler import record_function

from tauv_vision_tpu_torch.configs.centernet import (
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfigSet,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import sow_dcn_offsets
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


def dcn_offset_penalty(offsets: Sequence[torch.Tensor], offset_range: float) -> torch.Tensor:
    """The mean squared excess of |offset| over ``offset_range``, over every
    offset of every DCN block's forward (``sow_dcn_offsets``); 0 when there
    are none."""
    if not offsets:
        return torch.zeros(())
    excess = sum(torch.sum(torch.square(torch.clamp_min(torch.abs(o.float()) - offset_range, 0.0)))
                 for o in offsets)
    return excess / sum(o.numel() for o in offsets)


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
):
    """One optimizer step on the loss of a batch: forward in training mode
    (batch statistics, the running ones updated), ``centernet_loss``, the
    DCN offset penalty where ``loss_lambda_dcn_offset`` > 0, backward and
    the optimizer's step (clipping included).  The losses come back
    detached, on the device.  ``watch``: the step returns (state, losses,
    ``watch_metrics`` of the parameters and raw gradients before the
    optimizer's step), as the JAX step built with ``watch=True`` does."""
    reg = train_config.loss_lambda_dcn_offset
    reg_range = train_config.dcn_offset_range

    def step(state: TrainState, img: torch.Tensor, truth: CenternetTruth):
        if torch.is_inference_mode_enabled():
            raise RuntimeError("a train step cannot run inside torch.inference_mode")
        model, optimizer = state.model, state.optimizer
        sow = sow_dcn_offsets(model) if reg > 0 else contextlib.nullcontext([])
        with torch.enable_grad(), model_mode(model, True), sow as offsets:
            optimizer.zero_grad(set_to_none=True)
            with record_function(FORWARD):
                prediction = model(img)
                losses = centernet_loss(prediction, truth, model_config, train_config,
                                        object_config)
                if reg > 0:
                    penalty = dcn_offset_penalty(offsets, reg_range).to(losses.total.device)
                    losses.dcn_offset = penalty
                    losses.total = losses.total + reg * penalty
            losses.total.backward()
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
):
    """The losses of a batch in inference mode (running statistics), with
    no graph."""

    def step(state: TrainState, img: torch.Tensor, truth: CenternetTruth):
        with torch.no_grad(), model_mode(state.model, False):
            prediction = state.model(img)
            return centernet_loss(prediction, truth, model_config, train_config,
                                  object_config).detach()

    return step


def _loss_train_step(loss_fn, watch: bool):
    """One optimizer step on ``loss_fn(prediction, truth)``: forward in
    training mode (batch statistics, the running ones updated), the loss,
    backward and the optimizer's step (clipping included).  The losses
    come back detached, on the device.  ``watch``: the step returns
    (state, losses, ``watch_metrics`` of the parameters and raw gradients
    before the optimizer's step)."""

    def step(state: TrainState, img: torch.Tensor, truth):
        if torch.is_inference_mode_enabled():
            raise RuntimeError("a train step cannot run inside torch.inference_mode")
        model, optimizer = state.model, state.optimizer
        with torch.enable_grad(), model_mode(model, True):
            optimizer.zero_grad(set_to_none=True)
            with record_function(FORWARD):
                prediction = model(img)
                with record_function(LOSS):
                    losses = loss_fn(prediction, truth)
            losses.total.backward()
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
):
    """``_loss_train_step`` on ``yolact_loss`` (a ``YolactTruth``)."""
    return _loss_train_step(
        lambda prediction, truth: yolact_loss(prediction, truth, model_config, train_config),
        watch)


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


def make_yolact_eval_step(model_config: YolactModelConfig, train_config: YolactTrainConfig):
    """The YOLACT losses of a batch in inference mode (running
    statistics), with no graph."""

    def step(state: TrainState, img: torch.Tensor, truth: YolactTruth):
        with torch.no_grad(), model_mode(state.model, False):
            prediction = state.model(img)
            return yolact_loss(prediction, truth, model_config, train_config).detach()

    return step
