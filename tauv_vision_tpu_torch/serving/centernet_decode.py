"""CenterNet decode into fixed-size detection tensors (counterpart of
``tauv_vision_tpu/serving/centernet_decode.py``).

Every output is a fixed ``n_detections`` tensor with a validity mask; the
greedy keypoint -> detection matcher is a loop over the keypoint peaks on
batched tensors, and pose recovery is the LM PnP of ``ops/pnp.py``, so
the whole decode stays on the device and never waits for it.

The JAX package's two fixes over the reference are kept: the keypoint /
detection affinity angle error is wrapped to [-pi, pi], and the PnP
result goes to the detection that owns the keypoints.

``impl="kernel"`` decodes heatmap peaks with ``peak_decode_cuda``
(kernel A on a CUDA tensor); ``impl="plain"`` with the plain
``peak_decode``.  Nothing else differs between the two.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from math import pi
from typing import Optional, Tuple

import numpy as np
import torch

from tauv_vision_tpu_torch.configs.centernet import CenternetModelConfig, ObjectConfigSet
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.ops.angles import angle_decode
from tauv_vision_tpu_torch.ops.depth import depth_decode
from tauv_vision_tpu_torch.ops.heatmap import gather_at_cells, gather_channel_at_cells
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda
from tauv_vision_tpu_torch.ops.pnp import PnPResult, solve_pnp_batch

IMPLS = ("kernel", "plain")


@dataclass
class Detections:
    """[B, K]-shaped decoded detections with a validity mask."""

    valid: torch.Tensor   # [B, K] bool (score >= threshold)
    score: torch.Tensor   # [B, K]
    label: torch.Tensor   # [B, K] int32
    y: torch.Tensor       # [B, K] normalised center y
    x: torch.Tensor       # [B, K]
    h: torch.Tensor       # [B, K] normalised height
    w: torch.Tensor       # [B, K]

    yaw: Optional[torch.Tensor] = None    # [B, K]
    pitch: Optional[torch.Tensor] = None
    roll: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None


@dataclass
class KeypointDetections:
    detections: Detections
    # Per-detection keypoint slots (S = most keypoints of any class).
    keypoint_valid: torch.Tensor      # [B, K, S] bool
    keypoint_y: torch.Tensor          # [B, K, S] normalised
    keypoint_x: torch.Tensor          # [B, K, S]
    keypoint_score: torch.Tensor      # [B, K, S]
    keypoint_affinity: torch.Tensor   # [B, K, S, 2]
    # PnP pose (cam_t_object).
    pose_valid: torch.Tensor          # [B, K] bool
    pose_rotation: torch.Tensor       # [B, K, 3, 3]
    pose_translation: torch.Tensor    # [B, K, 3]
    pose_error: torch.Tensor          # [B, K]


@dataclass
class KeypointPeaks:
    """[B, Kk] keypoint peaks: validity, channel, normalised cell
    position, score and the affinity vector of the peak's channel."""

    valid: torch.Tensor
    label: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    score: torch.Tensor
    affinity: torch.Tensor   # [B, Kk, 2]


def _peaks(impl: str):
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return peak_decode_cuda if impl == "kernel" else peak_decode


def decode(
    prediction: Prediction,
    model_config: CenternetModelConfig,
    n_detections: int,
    score_threshold: float,
    impl: str = "kernel",
) -> Detections:
    """Dense prediction maps -> top-k detections, with yaw / pitch / roll
    and depth where the prediction carries those heads."""
    mc = model_config
    # Kernel A reads contiguous NCHW; a head of ``quantize.quantized_call``
    # emits a channels-last map.
    index, label, score = _peaks(impl)(prediction.heatmap_nchw().contiguous(), n_detections)

    size = gather_at_cells(prediction.size, index)      # [B, K, 2]
    offset = gather_at_cells(prediction.offset, index)  # [B, K, 2]
    iy = index[..., 0].to(torch.float32)
    ix = index[..., 1].to(torch.float32)
    y = (mc.downsample_ratio * iy + offset[..., 0]) / mc.in_h
    x = (mc.downsample_ratio * ix + offset[..., 1]) / mc.in_w

    def angle_at_cells(name):
        bin_head = getattr(prediction, f"{name}_bin")
        if bin_head is None:
            return None
        return angle_decode(gather_at_cells(bin_head, index),
                            gather_at_cells(getattr(prediction, f"{name}_offset"), index),
                            2 * pi, mc.angle_bin_overlap)

    depth = None
    if prediction.depth is not None:
        depth = depth_decode(gather_at_cells(prediction.depth, index)[..., 0])
    return Detections(
        valid=score >= score_threshold, score=score, label=label,
        y=y, x=x, h=size[..., 0], w=size[..., 1],
        yaw=angle_at_cells("yaw"), pitch=angle_at_cells("pitch"),
        roll=angle_at_cells("roll"), depth=depth,
    )


def _keypoint_tables(object_config: ObjectConfigSet):
    """Per-channel (owner label, local slot) tables and the per-label
    padded 3D keypoint banks, as numpy."""
    owner = np.asarray(object_config.keypoint_owner_labels(), np.int64)
    local = np.zeros(object_config.n_keypoints, np.int64)
    for flat in range(object_config.n_keypoints):
        _, local[flat] = object_config.decode_keypoint_index(flat)

    max_slots = max(
        (len(c.keypoints) if c.keypoints is not None else 0)
        for c in object_config.configs
    )
    kp3d = np.zeros((object_config.n_labels, max_slots, 3), np.float32)
    kp3d_mask = np.zeros((object_config.n_labels, max_slots), bool)
    for li, c in enumerate(object_config.configs):
        if c.keypoints is None:
            continue
        for si, kp in enumerate(c.keypoints):
            kp3d[li, si] = kp
            kp3d_mask[li, si] = True
    return owner, local, kp3d, kp3d_mask, max_slots


@functools.lru_cache(maxsize=16)
def _device_tables(object_config: ObjectConfigSet, device: torch.device):
    """``_keypoint_tables`` on ``device``, uploaded once: an upload from
    pageable memory would wait for the device on every request."""
    owner, local, kp3d, kp3d_mask, max_slots = _keypoint_tables(object_config)
    return (*(torch.from_numpy(a).to(device) for a in (owner, local, kp3d, kp3d_mask)),
            max_slots)


def keypoint_peaks(
    prediction: Prediction,
    model_config: CenternetModelConfig,
    keypoint_n_detections: int,
    keypoint_score_threshold: float,
    impl: str = "kernel",
) -> KeypointPeaks:
    """Top-k keypoint peaks over all keypoint channels, and the affinity
    vector of each peak's own channel at its cell."""
    mc = model_config
    index, label, score = _peaks(impl)(prediction.keypoint_heatmap_nchw(),
                                       keypoint_n_detections)
    return KeypointPeaks(
        valid=score >= keypoint_score_threshold,
        label=label,
        y=index[..., 0].to(torch.float32) / (mc.in_h // mc.downsample_ratio),
        x=index[..., 1].to(torch.float32) / (mc.in_w // mc.downsample_ratio),
        score=score,
        affinity=gather_channel_at_cells(prediction.keypoint_affinity, index, label),
    )


def match_keypoints(
    detections: Detections, peaks: KeypointPeaks, object_config: ObjectConfigSet,
) -> Tuple[torch.Tensor, ...]:
    """Greedy matcher: each keypoint peak, in score order, goes to the
    valid detection of its owning class whose direction from the
    detection centre best agrees with the peak's affinity angle, among
    those whose slot for that keypoint is still free.

    Returns (slots_y, slots_x, slots_score [B, K, S], slots_affinity
    [B, K, S, 2], claimed [B, K, S] bool).  The JAX package runs a
    ``fori_loop`` over the peaks, vmapped over the batch; here the
    angle errors of every (peak, detection) pair are computed at once, the
    loop over the peaks carries only the claimed table (an argmin a step,
    ``torch.argmin`` taking the first minimum as ``jnp.argmin`` does, so
    an all-``inf`` row picks 0 and assigns nothing), and the claimed
    peaks are written into their slots after it.  A slot is claimed at
    most once, so this is the sequence of writes the JAX loop makes."""
    owner, local, _, _, n_slots = _device_tables(object_config, peaks.y.device)
    b, n_k = detections.valid.shape
    n_kk = peaks.y.shape[1]
    channel = peaks.label.long()
    slot = local[channel]                                      # [B, Kk]

    aff_angle = torch.atan2(peaks.affinity[..., 0], peaks.affinity[..., 1])   # [B, Kk]
    det_angle = torch.atan2(peaks.y[..., None] - detections.y[:, None],
                            peaks.x[..., None] - detections.x[:, None])       # [B, Kk, K]
    # Wrapped to [-pi, pi] (the reference compares the raw difference).
    err = torch.abs(torch.remainder(aff_angle[..., None] - det_angle + pi, 2 * pi) - pi)
    owned = detections.valid[:, None] & (detections.label[:, None] == owner[channel][..., None])
    inf = torch.full((), float("inf"), dtype=err.dtype, device=err.device)

    claimed = torch.zeros((b, n_k * n_slots), dtype=torch.int32, device=err.device)
    # The claimed-table cell of (detection, the peak's slot).
    cells = torch.arange(n_k, device=err.device) * n_slots + slot[..., None]  # [B, Kk, K]
    best_of, assigned_of = [], []
    for j in range(n_kk):
        free = torch.gather(claimed, 1, cells[:, j]) == 0
        err_j = torch.where(owned[:, j] & free, err[:, j], inf)
        best = torch.argmin(err_j, dim=1, keepdim=True)        # [B, 1]
        assign = peaks.valid[:, j, None] & torch.isfinite(torch.gather(err_j, 1, best))
        claimed.scatter_add_(1, best * n_slots + slot[:, j, None], assign.to(torch.int32))
        best_of.append(best)
        assigned_of.append(assign)
    best = torch.cat(best_of, dim=1)                           # [B, Kk]
    assigned = torch.cat(assigned_of, dim=1)

    # Unassigned peaks write to one spare cell past the slots, dropped.
    target = torch.where(assigned, best * n_slots + slot,
                         torch.full_like(slot, n_k * n_slots))

    def place(values):
        shape = (b, n_k * n_slots + 1) + values.shape[2:]
        index = target.reshape(target.shape + (1,) * (values.dim() - 2)).expand_as(values)
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.scatter_(1, index, values)[:, :-1].reshape((b, n_k, n_slots) + values.shape[2:])

    return (place(peaks.y), place(peaks.x), place(peaks.score), place(peaks.affinity),
            claimed.reshape(b, n_k, n_slots) > 0)


def keypoint_poses(
    detections: Detections,
    slots_y: torch.Tensor,
    slots_x: torch.Tensor,
    claimed: torch.Tensor,
    model_config: CenternetModelConfig,
    object_config: ObjectConfigSet,
    projection_matrix: torch.Tensor,
) -> PnPResult:
    """PnP for every detection slot on its claimed keypoints ([B, K]
    fields); valid where at least ``pnp.MIN_POINTS`` (6) were claimed."""
    mc = model_config
    _, _, kp3d, kp3d_mask, n_slots = _device_tables(object_config, slots_y.device)
    b, n_k = detections.label.shape
    label = detections.label.long()
    object_points = kp3d[label]                                # [B, K, S, 3]
    pnp_mask = claimed & kp3d_mask[label]
    # (u, v) pixels, the reference's order.
    image_points = torch.stack((slots_x * mc.in_w, slots_y * mc.in_h), dim=-1)
    flat = solve_pnp_batch(
        object_points.reshape(b * n_k, n_slots, 3),
        image_points.reshape(b * n_k, n_slots, 2),
        projection_matrix, pnp_mask.reshape(b * n_k, n_slots),
    )
    return PnPResult(rotation=flat.rotation.reshape(b, n_k, 3, 3),
                     translation=flat.translation.reshape(b, n_k, 3),
                     error=flat.error.reshape(b, n_k), valid=flat.valid.reshape(b, n_k))


def decode_keypoints(
    prediction: Prediction,
    model_config: CenternetModelConfig,
    object_config: ObjectConfigSet,
    projection_matrix: torch.Tensor,
    n_detections: int,
    keypoint_n_detections: int,
    score_threshold: float,
    keypoint_score_threshold: float,
    impl: str = "kernel",
) -> KeypointDetections:
    """The full keypoint decode: detect objects and keypoint peaks, match
    each peak (``match_keypoints``), then solve PnP for the detections
    with at least 6 claimed keypoints (``keypoint_poses``).
    ``projection_matrix`` [3, 3] or [3, 4] lies on the prediction's
    device."""
    detections = decode(prediction, model_config, n_detections, score_threshold, impl)
    peaks = keypoint_peaks(prediction, model_config, keypoint_n_detections,
                           keypoint_score_threshold, impl)
    slots_y, slots_x, slots_score, slots_aff, claimed = match_keypoints(
        detections, peaks, object_config)
    pose = keypoint_poses(detections, slots_y, slots_x, claimed, model_config,
                          object_config, projection_matrix)
    return KeypointDetections(
        detections=detections,
        keypoint_valid=claimed,
        keypoint_y=slots_y,
        keypoint_x=slots_x,
        keypoint_score=slots_score,
        keypoint_affinity=slots_aff,
        pose_valid=pose.valid & detections.valid,
        pose_rotation=pose.rotation,
        pose_translation=pose.translation,
        pose_error=pose.error,
    )
