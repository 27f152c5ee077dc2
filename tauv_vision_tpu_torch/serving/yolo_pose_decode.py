"""YOLO-Pose decode (counterpart of
``tauv_vision_tpu/serving/yolo_pose_decode.py``): box decode -> Fast-NMS
-> each kept detection's belief maps from the last Pointnet stage's
prototypes -> each map's peak -> PnP on the recovered keypoints.

The belief maps are sigmoid(coefficients . prototypes) with no crop, the
function of mask assembly, so ``impl="kernel"`` assembles them with
kernel B (``assemble_mask_cuda``) and ``impl="plain"`` with its plain
version.  Fixed shapes throughout; nothing syncs with the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig
from tauv_vision_tpu_torch.models.yolo_pose import YoloPosePrediction
from tauv_vision_tpu_torch.ops.boxes import box_decode
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.nms import fast_nms
from tauv_vision_tpu_torch.ops.pnp import PNP_ITERATIONS, solve_pnp_batch
from tauv_vision_tpu_torch.serving.yolact_decode import IMPLS, _take

# A pose needs this many keypoints above the score threshold (the JAX
# decode's ``min_points``; the CenterNet node's PnP needs 6).
MIN_KEYPOINTS = 4


@dataclass
class YoloPoseDetections:
    valid: torch.Tensor            # [B, K] bool
    score: torch.Tensor            # [B, K]
    label: torch.Tensor            # [B, K] int32 (1..C)
    box: torch.Tensor              # [B, K, 4] decoded (y, x, h, w)
    belief: torch.Tensor           # [B, K, Kp, bh, bw] assembled belief maps
    keypoint_y: torch.Tensor       # [B, K, Kp] normalised
    keypoint_x: torch.Tensor       # [B, K, Kp]
    keypoint_score: torch.Tensor   # [B, K, Kp]
    pose_valid: Optional[torch.Tensor] = None        # [B, K]
    pose_rotation: Optional[torch.Tensor] = None     # [B, K, 3, 3]
    pose_translation: Optional[torch.Tensor] = None  # [B, K, 3]


def select_detections(
    prediction: YoloPosePrediction,
    config: YoloPoseModelConfig,
    top_k: int,
    iou_threshold: float,
    confidence_threshold: float,
):
    """Fast-NMS's picks: (keep [B, K], boxes [B, K, 4], class logits
    [B, K, C+1], belief coefficients [B, K * Kp, Pb], one row a detection
    and keypoint, as kernel B takes them)."""
    box = box_decode(prediction.box_encoding, prediction.anchor[None], config.box_variances)
    keep_index, keep = fast_nms(prediction.classification, box, top_k, iou_threshold,
                                confidence_threshold)
    b, k = keep_index.shape
    n_kp, n_proto = prediction.belief_coeff.shape[2:]
    coeff = _take(prediction.belief_coeff.flatten(2), keep_index).reshape(b, k * n_kp, n_proto)
    return keep, _take(box, keep_index), _take(prediction.classification, keep_index), coeff


def decode_yolo_pose(
    prediction: YoloPosePrediction,
    config: YoloPoseModelConfig,
    top_k: int,
    iou_threshold: float,
    confidence_threshold: float,
    impl: str = "kernel",
) -> YoloPoseDetections:
    """Detections with their belief maps and keypoints; no pose
    (``attach_pnp`` adds it)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    keep, sel_box, sel_cls, sel_coeff = select_detections(
        prediction, config, top_k, iou_threshold, confidence_threshold)
    b, k = keep.shape
    n_kp = prediction.belief_coeff.shape[2]

    confidence = torch.softmax(sel_cls, dim=-1)[..., 1:]
    score = confidence.amax(dim=-1)
    label = confidence.argmax(dim=-1).to(torch.int32) + 1  # first maximum

    # The last cascade stage's prototypes (DOPE reads the last stage at
    # inference), [B, Pb, bh, bw] from their NHWC view.
    proto = prediction.belief_prototypes[-1].permute(0, 3, 1, 2)
    bh, bw = proto.shape[-2:]
    assemble = assemble_mask_cuda if impl == "kernel" else assemble_mask_batch
    belief = assemble(proto, sel_coeff).reshape(b, k, n_kp, bh, bw)

    # The first maximum in row-major (h, w) order, as jnp.argmax.
    flat = belief.flatten(3)
    kp_score, kp_idx = flat.amax(dim=-1), flat.argmax(dim=-1)
    kp_y = torch.div(kp_idx, bw, rounding_mode="floor").to(torch.float32) / bh
    kp_x = (kp_idx % bw).to(torch.float32) / bw
    return YoloPoseDetections(valid=keep, score=score, label=label, box=sel_box,
                              belief=belief, keypoint_y=kp_y, keypoint_x=kp_x,
                              keypoint_score=kp_score)


def attach_pnp(
    detections: YoloPoseDetections,
    config: YoloPoseModelConfig,
    object_points: torch.Tensor,
    camera_matrix: torch.Tensor,
    keypoint_score_threshold: float = 0.3,
    pnp_iterations: int = PNP_ITERATIONS,
) -> YoloPoseDetections:
    """``detections`` with each slot's pose: batched LM PnP over every
    (image, detection) slot's keypoints at pixel (u, v) = (x in_w, y in_h),
    those scoring at least the threshold, valid with ``MIN_KEYPOINTS`` of
    them where the detection is kept.  ``object_points`` [Kp, 3] and
    ``camera_matrix`` [3, 3], f32 on the detections' device."""
    b, k, n_kp = detections.keypoint_score.shape
    image_points = torch.stack((detections.keypoint_x * config.in_w,
                                detections.keypoint_y * config.in_h), dim=-1)
    mask = detections.keypoint_score >= keypoint_score_threshold
    result = solve_pnp_batch(object_points[None].expand(b * k, n_kp, 3),
                             image_points.reshape(b * k, n_kp, 2), camera_matrix,
                             mask.reshape(b * k, n_kp), n_iterations=pnp_iterations,
                             min_points=MIN_KEYPOINTS)
    return dataclasses.replace(detections,
                               pose_valid=result.valid.reshape(b, k) & detections.valid,
                               pose_rotation=result.rotation.reshape(b, k, 3, 3),
                               pose_translation=result.translation.reshape(b, k, 3))
