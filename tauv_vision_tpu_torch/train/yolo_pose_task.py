"""YOLO-Pose loss and its belief and affinity targets, vectorised
(counterpart of ``tauv_vision_tpu/train/yolo_pose_task.py``).

- anchor <-> truth IoU matching and OHEM as the YOLACT's
  (``yolact_task.match_anchor_sets``: a double stable argsort, the lower
  anchor index first at a tie), the class cross entropy normalised by
  ``(1 + ratio) * n_pos``;
- box smooth-L1 on the *decoded* boxes against the matched truth boxes;
- over each sample's ``max_positive_anchors`` positives of highest match
  IoU (a stable descending sort: ``jax.lax.top_k``'s lower index first at
  a tie): the mask BCE against the object's instance mask, cropped by its
  truth box and normalised by the resized mask's area; per Pointnet stage
  the class-balanced belief BCE (``beta = 1 - mean(truth)`` for each
  anchor and keypoint) and the affinity MSE of ``2 (sigmoid - 1/2)``
  against the radius-limited unit vectors toward the object's centre.
  A slot past a sample's positives gathers object ``match_index[anchor]``
  all the same and is masked out by ``where``, as JAX's is.

The truth maps are rendered at the first stage's resolution and resized
to each stage (``resize_bilinear``, bit-equal to ``jax.image.resize``).
The mask truth compares the seg map with object slots, as the JAX
package does.  Sums run as JAX's ``vmap`` of a sample's loss runs them:
each sample's slots, then its stages, then the batch, then the division
by the batch's positives.  Clips follow JAX's gradients (``losses.clip``;
``jnp.clip(x, lo)`` clips from below only).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig
from tauv_vision_tpu_torch.models.yolo_pose import YoloPosePrediction
from tauv_vision_tpu_torch.ops.boxes import box_decode, box_to_mask
from tauv_vision_tpu_torch.ops.image import resize_bilinear
from tauv_vision_tpu_torch.ops.losses import binary_cross_entropy, clip, softmax_cross_entropy
from tauv_vision_tpu_torch.train.yolact_task import _gather_rows, match_anchor_sets

PROB_CLIP = 1e-4         # the floor (and 1 - the ceiling) of the clipped sigmoids


@dataclass
class YoloPoseTruth:
    """A padded truth batch of fixed shape, as numpy arrays (from
    ``collate_fat``) or tensors (``to``)."""

    valid: torch.Tensor           # [B, M] bool
    classification: torch.Tensor  # [B, M] int32
    box: torch.Tensor             # [B, M, 4] normalised (y, x, h, w)
    seg_map: torch.Tensor         # [B, H, W] int32 object slot, 255 elsewhere
    keypoints: torch.Tensor       # [B, M, K, 2] (y, x) pixels at the input size
    keypoint_valid: torch.Tensor  # [B, M, K] bool
    centers: torch.Tensor         # [B, M, 2] (y, x) pixels at the input size

    def to(self, device) -> "YoloPoseTruth":
        """Every field as a tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self)})


@dataclass
class YoloPoseLosses:
    total: torch.Tensor
    classification: torch.Tensor
    box: torch.Tensor
    mask: torch.Tensor
    belief: torch.Tensor
    affinity: torch.Tensor

    def detach(self) -> "YoloPoseLosses":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).detach() for f in dataclasses.fields(self)})


def _grid(size: Tuple[int, int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    h, w = size
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


def create_belief(size: Tuple[int, int], points: torch.Tensor, point_valid: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """Gaussian belief maps, one channel per keypoint: points [..., K, 2]
    (y, x) in target pixels -> [..., K, H, W], zero for an invalid
    point."""
    gy, gx = _grid(size, points.device)
    d2 = ((gy - points[..., 0][..., None, None]) ** 2
          + (gx - points[..., 1][..., None, None]) ** 2)
    belief = torch.exp(-d2 / (2.0 * sigma ** 2))
    return belief * point_valid[..., None, None].float()


def create_affinity(size: Tuple[int, int], points: torch.Tensor, point_valid: torch.Tensor,
                    center: torch.Tensor, radius: float) -> torch.Tensor:
    """Unit vectors from each keypoint toward the object's centre, within
    ``radius`` pixels of the keypoint: points [..., K, 2], center [..., 2]
    -> [..., 2K, H, W], the (y, x) pair of each keypoint interleaved."""
    gy, gx = _grid(size, points.device)
    dy = points[..., 0][..., None, None] - gy
    dx = points[..., 1][..., None, None] - gx
    dist = torch.sqrt(dy ** 2 + dx ** 2)
    inside = ((dist <= radius) & point_valid[..., None, None].bool()).float()

    vy = center[..., 0][..., None, None, None] - points[..., 0][..., None, None]
    vx = center[..., 1][..., None, None, None] - points[..., 1][..., None, None]
    norm = torch.sqrt(vy ** 2 + vx ** 2)
    norm = torch.where(norm > 0, norm, torch.ones_like(norm))
    stacked = torch.stack(((vy / norm) * inside, (vx / norm) * inside), dim=-3)
    return stacked.reshape(*stacked.shape[:-4], 2 * stacked.shape[-4], *stacked.shape[-2:])


def _resize_slots(maps: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[B, S, C, h, w] resized to ``size`` along h and w."""
    b, s = maps.shape[:2]
    return resize_bilinear(maps.flatten(0, 1), size).reshape(b, s, *maps.shape[2:-2], *size)


def _where_sel(sel: torch.Tensor, per_slot: torch.Tensor) -> torch.Tensor:
    """Each sample's sum over its selected slots: [B, S] -> [B]."""
    return torch.where(sel, per_slot, torch.zeros_like(per_slot)).sum(dim=1)


def yolo_pose_loss(prediction: YoloPosePrediction, truth: YoloPoseTruth,
                   config: YoloPoseModelConfig, max_positive_anchors: int = 16) -> YoloPoseLosses:
    """Every loss term of a prediction against its truth (tensors on the
    prediction's device)."""
    cfg = config
    sets = match_anchor_sets(prediction, truth, cfg, max_positive_anchors)
    positive, match_index = sets.positive, sets.match_index
    n_pos_f = torch.clamp_min(positive.sum().float(), 1.0)

    # ---- classification with OHEM's negatives ----------------------------
    with torch.no_grad():
        match_cls = torch.gather(truth.classification.long(), 1, match_index)
        match_cls = torch.where(positive, match_cls, torch.zeros_like(match_cls))
    ce = softmax_cross_entropy(prediction.classification, match_cls)
    l_cls = (sets.selected.float() * ce).sum() / ((1 + cfg.negative_example_ratio) * n_pos_f)

    # ---- box smooth-L1 on the decoded boxes ------------------------------
    box = box_decode(prediction.box_encoding, prediction.anchor[None], cfg.box_variances)
    diff = torch.abs(box - _gather_rows(truth.box, match_index))
    sl1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
    l_box = (positive[..., None].float() * sl1).sum() / n_pos_f

    # ---- mask, belief and affinity over the capped positives -------------
    top_anchor, sel = sets.top_anchor, sets.top_valid           # [B, S]
    proto = prediction.mask_prototype                             # [B, h, w, P]
    proto_hw = tuple(proto.shape[1:3])
    n_objects = truth.box.shape[1]
    with torch.no_grad():
        sel_obj = torch.gather(match_index, 1, top_anchor)        # [B, S]
        obj_ids = torch.arange(n_objects, device=truth.seg_map.device)
        inst = (truth.seg_map[:, None] == obj_ids[None, :, None, None]).float()
        inst_resized = resize_bilinear(inst, proto_hw)            # [B, M, h, w]
        truth_mask = _gather_rows(inst_resized, sel_obj)          # [B, S, h, w]
        area = torch.gather(inst_resized.sum(dim=(2, 3)), 1, sel_obj)
        crop = box_to_mask(_gather_rows(truth.box, sel_obj), proto_hw)

        # The truth maps at the first stage's resolution, each object's.
        bh, bw = prediction.belief_prototypes[0].shape[1:3]
        scale = torch.tensor([bh / truth.seg_map.shape[1], bw / truth.seg_map.shape[2]],
                             dtype=torch.float32, device=proto.device)
        kp_scaled = truth.keypoints * scale
        truth_belief = create_belief((bh, bw), kp_scaled, truth.keypoint_valid,
                                     cfg.belief_sigma)            # [B, M, K, bh, bw]
        truth_affinity = create_affinity((bh, bw), kp_scaled, truth.keypoint_valid,
                                         truth.centers * scale, cfg.affinity_radius)
        slot_belief = _gather_rows(truth_belief, sel_obj)         # [B, S, K, bh, bw]
        slot_affinity = _gather_rows(truth_affinity, sel_obj)     # [B, S, 2K, bh, bw]

    logits = torch.einsum("bsp,bhwp->bshw", _gather_rows(prediction.mask_coeff, top_anchor),
                          proto)
    pred_mask = clip(torch.sigmoid(logits), PROB_CLIP)
    bce = binary_cross_entropy(clip(pred_mask, PROB_CLIP, 1 - PROB_CLIP), truth_mask)
    per = (crop * bce).sum(dim=(2, 3))
    per = torch.where((area > 0) & sel, per / torch.clamp_min(area, 1e-6),
                      torch.zeros_like(per))
    mask_sums = per.sum(dim=1)

    belief_coeff = _gather_rows(prediction.belief_coeff, top_anchor)      # [B, S, K, Pb]
    affinity_coeff = _gather_rows(prediction.affinity_coeff, top_anchor)  # [B, S, 2K, Pa]
    belief_sums = torch.zeros(proto.shape[0], device=proto.device)
    affinity_sums = torch.zeros(proto.shape[0], device=proto.device)
    for bproto, aproto in zip(prediction.belief_prototypes, prediction.affinity_prototypes):
        size = tuple(bproto.shape[1:3])
        tb = _resize_slots(slot_belief, size)
        ta = _resize_slots(slot_affinity, size)

        bel = torch.einsum("bskp,bhwp->bskhw", belief_coeff, bproto)
        bel = clip(torch.sigmoid(bel), PROB_CLIP, 1 - PROB_CLIP)
        beta = 1.0 - tb.mean(dim=(-1, -2), keepdim=True)
        bce_map = (-beta * tb * torch.log(bel)
                   - (1.0 - beta) * (1.0 - tb) * torch.log(1.0 - bel))
        belief_sums = belief_sums + _where_sel(sel, bce_map.mean(dim=(2, 3, 4)))

        aff = torch.einsum("bskp,bhwp->bskhw", affinity_coeff, aproto)
        aff = 2.0 * (clip(torch.sigmoid(aff), PROB_CLIP) - 0.5)
        mse = (aff - ta) ** 2
        affinity_sums = affinity_sums + _where_sel(sel, mse.mean(dim=(2, 3, 4)))

    l_mask = mask_sums.sum() / n_pos_f
    l_belief = belief_sums.sum() / n_pos_f
    l_affinity = affinity_sums.sum() / n_pos_f
    total = l_cls + l_box + l_mask + l_belief + l_affinity
    return YoloPoseLosses(total=total, classification=l_cls, box=l_box, mask=l_mask,
                          belief=l_belief, affinity=l_affinity)
