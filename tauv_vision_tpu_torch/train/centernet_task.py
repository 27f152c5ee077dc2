"""CenterNet loss, vectorised (counterpart of
``tauv_vision_tpu/train/centernet_task.py``).

Targets are rendered inside the step (``ops/heatmap.py``), per-object
predictions at the centre cells are one gather, the object count divides
as ``max(n_valid, 1)``, and a class with no angle modulo takes 2 pi.

Under a data mesh (``parallel/mesh.py``) each rank holds its rows of the
global batch: the object count and the focal loss's peak count are the
global ones, so each additive term is this rank's share and the terms'
sum over the ranks is the single-device loss of the global batch
(``CenternetLosses``); ``avg_size_error`` is the rank's share of the global
mean and ``max_size_error`` the global maximum, on every rank.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from math import pi
from typing import Optional

import numpy as np
import torch

from tauv_vision_tpu_torch.configs.centernet import (
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfigSet,
)
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.ops.angles import angle_loss
from tauv_vision_tpu_torch.ops.depth import depth_loss
from tauv_vision_tpu_torch.ops.heatmap import (
    gather_at_cells,
    generate_heatmap,
    generate_keypoint_heatmap,
    out_index_for_position,
)
from tauv_vision_tpu_torch.ops.losses import focal_loss
from tauv_vision_tpu_torch.parallel.mesh import parallel, pmax, psum


@dataclass
class CenternetTruth:
    """A padded truth batch of fixed shape, as numpy arrays (from the data
    generator) or tensors (``to``)."""

    valid: torch.Tensor                 # [B, N] bool
    label: torch.Tensor                 # [B, N] int32
    center: torch.Tensor                # [B, N, 2] normalised (y, x)
    size: torch.Tensor                  # [B, N, 2] normalised (h, w)

    roll: Optional[torch.Tensor] = None   # [B, N]
    pitch: Optional[torch.Tensor] = None  # [B, N]
    yaw: Optional[torch.Tensor] = None    # [B, N]
    depth: Optional[torch.Tensor] = None  # [B, N]

    keypoint_valid: Optional[torch.Tensor] = None         # [B, K] bool
    keypoint_label: Optional[torch.Tensor] = None         # [B, K] int32
    keypoint_center: Optional[torch.Tensor] = None        # [B, K, 2]
    keypoint_object_index: Optional[torch.Tensor] = None  # [B, K] int32

    def to(self, device) -> "CenternetTruth":
        """Every field as a tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self) if getattr(self, f.name) is not None})


@dataclass
class CenternetLosses:
    total: torch.Tensor
    heatmap: torch.Tensor
    keypoint_heatmap: torch.Tensor
    keypoint_affinity: torch.Tensor
    offset: torch.Tensor
    size: torch.Tensor
    roll: torch.Tensor
    pitch: torch.Tensor
    yaw: torch.Tensor
    depth: torch.Tensor
    avg_size_error: torch.Tensor
    max_size_error: torch.Tensor
    # The DCN offset-range penalty (0 when disabled); the train step adds
    # it, from the offsets the DCN blocks keep.
    dcn_offset: torch.Tensor = 0.0

    # The one field that is not a sum of the ranks' shares under a mesh.
    NOT_ADDITIVE = ("max_size_error",)

    def detach(self) -> "CenternetLosses":
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name)).detach()
            for f in dataclasses.fields(self)})


def _modulo_table(object_config: ObjectConfigSet, which: str) -> np.ndarray:
    """The angle modulo of each label; 0 stands for none configured."""
    return np.asarray([0.0 if getattr(c, which).modulo is None else float(getattr(c, which).modulo)
                       for c in object_config.configs], dtype=np.float32)


def centernet_loss(
    prediction: Prediction,
    truth: CenternetTruth,
    model_config: CenternetModelConfig,
    train_config: CenternetTrainConfig,
    object_config: ObjectConfigSet,
    mesh=None,
) -> CenternetLosses:
    """Every loss term of a prediction against its truth (tensors on the
    prediction's device); under a data ``mesh``, this rank's shares."""
    mc, tc, oc = model_config, train_config, object_config
    device = prediction.heatmap.device
    zero = torch.zeros((), device=device)

    valid_f = truth.valid.float()
    n_valid = torch.clamp_min(psum(valid_f.sum(), mesh), 1.0)

    heatmap_target = generate_heatmap(
        truth.center, truth.label, truth.valid,
        n_labels=oc.n_labels, in_h=mc.in_h, in_w=mc.in_w,
        downsample_ratio=mc.downsample_ratio, sigma=tc.keypoint_heatmap_sigma,
    )
    l_heatmap = focal_loss(torch.sigmoid(prediction.heatmap_nchw()), heatmap_target,
                           alpha=tc.heatmap_focal_loss_a, beta=tc.heatmap_focal_loss_b,
                           mesh=mesh).sum()
    total = l_heatmap

    l_keypoint_heatmap = l_keypoint_affinity = zero
    if prediction.keypoint_heatmap is not None:
        kp_heatmap_target, kp_aff_weight, kp_aff_target = generate_keypoint_heatmap(
            truth.keypoint_center, truth.keypoint_label, truth.keypoint_valid,
            truth.keypoint_object_index, truth.center,
            n_keypoints=oc.n_keypoints, in_h=mc.in_h, in_w=mc.in_w,
            downsample_ratio=mc.downsample_ratio,
            heatmap_sigma=tc.keypoint_heatmap_sigma,
            affinity_sigma=tc.keypoint_affinity_sigma,
        )
        l_keypoint_heatmap = tc.loss_lambda_keypoint_heatmap * focal_loss(
            torch.sigmoid(prediction.keypoint_heatmap_nchw()), kp_heatmap_target,
            alpha=tc.heatmap_focal_loss_a, beta=tc.heatmap_focal_loss_b, mesh=mesh,
        ).sum()
        total = total + l_keypoint_heatmap
        # [B, H, W, K, 2] -> [B, K, 2, H, W]
        aff_pred = prediction.keypoint_affinity.permute(0, 3, 4, 1, 2)
        mse = (aff_pred - kp_aff_target) ** 2
        l_keypoint_affinity = tc.loss_lambda_keypoint_affinity * (
            kp_aff_weight[:, :, None] * mse).sum()
        total = total + l_keypoint_affinity

    out_index = out_index_for_position(truth.center, mc.in_h, mc.in_w, mc.downsample_ratio)
    pred_size = gather_at_cells(prediction.size, out_index)      # [B, N, 2]
    pred_offset = gather_at_cells(prediction.offset, out_index)  # [B, N, 2]

    size_error = torch.abs(pred_size - truth.size)
    l_size = tc.loss_lambda_size * (valid_f[..., None] * size_error).sum() / n_valid
    total = total + l_size
    with torch.no_grad():
        valid = truth.valid[..., None]
        if parallel(mesh):
            n_errors = mesh.psum(valid.expand_as(size_error).sum().float())
            avg_size_error = torch.where(
                n_errors > 0, torch.where(valid, size_error, 0.0).sum() / n_errors, torch.nan)
        else:
            avg_size_error = torch.nanmean(torch.where(valid, size_error, torch.nan))
        max_size_error = pmax(torch.where(valid, size_error, 0.0).amax(), mesh)

    px_center = truth.center * torch.tensor([mc.in_h, mc.in_w], dtype=torch.float32,
                                            device=device)
    px_offset = px_center - mc.downsample_ratio * torch.trunc(px_center / mc.downsample_ratio)
    l_offset = tc.loss_lambda_offset * (
        valid_f[..., None] * torch.abs(pred_offset - px_offset)).sum() / n_valid
    total = total + l_offset

    def angle_term(bin_head, offset_head, truth_angle, which):
        table = torch.from_numpy(_modulo_table(oc, which)).to(device)
        theta_range = table[truth.label.long()]
        theta_range = torch.where(theta_range > 0, theta_range, 2 * pi)
        per_obj = angle_loss(gather_at_cells(bin_head, out_index),
                             gather_at_cells(offset_head, out_index),
                             truth_angle, theta_range, mc.angle_bin_overlap)
        return tc.loss_lambda_angle * (valid_f * per_obj).sum() / n_valid

    angles = {}
    for name in ("roll", "pitch", "yaw"):
        angles[name] = zero
        if getattr(prediction, f"{name}_bin") is not None:
            angles[name] = angle_term(getattr(prediction, f"{name}_bin"),
                                      getattr(prediction, f"{name}_offset"),
                                      getattr(truth, name), name)
            total = total + angles[name]

    l_depth = zero
    if prediction.depth is not None:
        pred_depth = gather_at_cells(prediction.depth, out_index)[..., 0]  # [B, N]
        l_depth = tc.loss_lambda_depth * (
            valid_f * depth_loss(pred_depth, truth.depth)).sum() / n_valid
        total = total + l_depth

    return CenternetLosses(
        total=total, heatmap=l_heatmap, keypoint_heatmap=l_keypoint_heatmap,
        keypoint_affinity=l_keypoint_affinity, offset=l_offset, size=l_size,
        roll=angles["roll"], pitch=angles["pitch"], yaw=angles["yaw"], depth=l_depth,
        avg_size_error=avg_size_error, max_size_error=max_size_error,
    )
