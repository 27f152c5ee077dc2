"""YOLACT loss, vectorised (counterpart of
``tauv_vision_tpu/train/yolact_task.py``).

- anchor <-> truth IoU matching with the positive and negative thresholds;
- OHEM: each sample's ``negative_example_ratio`` x n_pos negatives of
  lowest background confidence, ranked by a double stable argsort (the
  lower anchor index first at a tie), the count a tensor (no host read);
- class cross entropy normalised by ``(1 + ratio) * n_pos``;
- box smooth-L1 on the encodings against ``box_encode`` of the matched
  truth (a non-positive anchor encodes against itself, so padded truth
  never reaches log(0));
- mask BCE of each trained anchor's assembled mask against its object's
  instance mask (bilinear-resized once per object to the prototypes'
  size), cropped by the truth box and the resized 254-invalid mask,
  normalised by the resized mask's area.

The mask loss runs over each sample's ``max_positive_anchors`` positives
of highest match IoU (a stable descending sort: ``jax.lax.top_k``'s lower
index first at a tie) and reports the positives the cap dropped
(``mask_clipped``).  With the cap None it runs over every positive, sample
by sample (one host read of the positives): JAX runs every anchor in
chunks and masks the others out, which adds exact zeros, so the value is
the same up to f32 summation order.

Clips follow JAX's gradients: ``jnp.clip`` is a maximum and a minimum,
whose derivative is 1/2 at a tie (``torch.clamp`` would give 1).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig, YolactTrainConfig
from tauv_vision_tpu_torch.models.yolact import YolactPrediction
from tauv_vision_tpu_torch.ops.boxes import box_encode, box_to_mask, iou_matrix
from tauv_vision_tpu_torch.ops.image import resize_bilinear, resize_nearest
from tauv_vision_tpu_torch.ops.losses import binary_cross_entropy, clip, softmax_cross_entropy

INVALID_SEG = 254
BACKGROUND_SEG = 255


@dataclass
class YolactTruth:
    """A padded truth batch of fixed shape, as numpy arrays (from the
    readers) or tensors (``to``)."""

    valid: torch.Tensor           # [B, M] bool
    classification: torch.Tensor  # [B, M] int32 (1..n_classes; 0 unused)
    box: torch.Tensor             # [B, M, 4] normalised (y, x, h, w)
    seg_map: torch.Tensor         # [B, H, W] int32 object index / 254 / 255
    img_valid: torch.Tensor       # [B, H, W] bool

    def to(self, device) -> "YolactTruth":
        """Every field as a tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self)})


@dataclass
class YolactLosses:
    total: torch.Tensor
    classification: torch.Tensor
    box: torch.Tensor
    mask: torch.Tensor
    # Positives the max_positive_anchors cap dropped this step (0 when the
    # cap is None or does not bind), so that a binding cap shows.
    mask_clipped: torch.Tensor = 0

    def detach(self) -> "YolactLosses":
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name)).detach()
            for f in dataclasses.fields(self)})


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of element i in a descending sort of ``scores``
    over the last axis (a double stable argsort: ties by index)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def _gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table [B, N, ...] at index [B, K] -> [B, K, ...]."""
    rows = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[rows, index]


def _anchor_set_loss(proto, coeff, obj, sel, inst_resized, inst_area, valid_resized, boxes):
    """Each sample's summed, cropped and normalised mask BCE over one set of
    anchors: proto [B, h, w, P], coeff [B, K, P], obj and sel [B, K] (the
    matched object and whether the anchor counts), the objects' resized
    masks [B, M, h, w] and areas [B, M], the resized valid mask
    [B, h, w] and the truth boxes [B, M, 4] -> [B]."""
    h, w = proto.shape[1:3]
    logits = torch.einsum("bkp,bhwp->bkhw", coeff, proto)
    pred_mask = clip(torch.sigmoid(logits), 1e-4, 1 - 1e-4)
    truth_mask = _gather_rows(inst_resized, obj)
    truth_area = torch.gather(inst_area, 1, obj)
    bce = binary_cross_entropy(pred_mask, truth_mask)
    crop = box_to_mask(_gather_rows(boxes, obj), (h, w)) * valid_resized[:, None]
    per_anchor = (crop * bce).sum(dim=(2, 3))
    per_anchor = torch.where((truth_area > 0) & sel,
                             per_anchor / torch.clamp_min(truth_area, 1e-6),
                             torch.zeros_like(per_anchor))
    return per_anchor.sum(dim=1)


@dataclass
class AnchorSets:
    """Which anchors a batch trains, from the truth, the anchors and the
    background confidence (no gradient)."""

    match_iou: torch.Tensor     # [B, A] the best IoU with a valid object
    match_index: torch.Tensor   # [B, A] that object (the first at a tie)
    positive: torch.Tensor      # [B, A] bool
    selected: torch.Tensor      # [B, A] bool: positives and OHEM's negatives
    top_anchor: torch.Tensor    # [B, K] the mask loss's anchors (capped), else [B, 0]
    top_valid: torch.Tensor     # [B, K] bool: which of them are positive


def match_anchors(prediction: YolactPrediction, truth: YolactTruth,
                  model_config: YolactModelConfig,
                  train_config: YolactTrainConfig) -> AnchorSets:
    return match_anchor_sets(prediction, truth, model_config,
                             train_config.max_positive_anchors)


@torch.no_grad()
def match_anchor_sets(prediction, truth, model_config, k_cap) -> AnchorSets:
    """``match_anchors`` of any prediction with ``classification`` and
    ``anchor`` (the YOLACT's, YOLO-Pose's) against any truth with ``box``
    and ``valid``, under any config with the IoU thresholds and
    ``negative_example_ratio``, the mask loss capped at ``k_cap`` anchors
    a sample (None: no cap)."""
    cfg = model_config
    iou = iou_matrix(prediction.anchor[None], truth.box) * truth.valid[:, None, :].float()
    match_iou = iou.amax(dim=2)
    match_index = torch.argmax(iou, dim=2)
    positive = match_iou >= cfg.iou_pos_threshold
    negative = match_iou <= cfg.iou_neg_threshold

    # OHEM: each negative's rank among its sample's negatives, hardest
    # (least confident background) first.
    bg_conf = torch.softmax(prediction.classification, dim=-1)[..., 0]
    neg_scores = torch.where(negative, -bg_conf, torch.full_like(bg_conf, -torch.inf))
    neg_rank = _rank_desc(neg_scores)
    k = cfg.negative_example_ratio * positive.sum(dim=1, keepdim=True)  # [B, 1]
    selected = positive | (negative & (neg_rank < k) & torch.isfinite(neg_scores))

    if k_cap is None:
        top_anchor = match_index[:, :0]
        top_valid = positive[:, :0]
    else:
        pos_scores = torch.where(positive, match_iou, torch.full_like(match_iou, -1.0))
        top_scores, top_anchor = torch.sort(pos_scores, dim=1, descending=True, stable=True)
        top_anchor, top_valid = top_anchor[:, :k_cap], top_scores[:, :k_cap] > 0.0
    return AnchorSets(match_iou, match_index, positive, selected, top_anchor, top_valid)


def yolact_loss(
    prediction: YolactPrediction,
    truth: YolactTruth,
    model_config: YolactModelConfig,
    train_config: YolactTrainConfig,
) -> YolactLosses:
    """Every loss term of a prediction against its truth (tensors on the
    prediction's device)."""
    cfg = model_config
    classification = prediction.classification  # [B, A, C+1]
    box_encoding = prediction.box_encoding      # [B, A, 4]
    mask_coeff = prediction.mask_coeff          # [B, A, P]
    anchor = prediction.anchor                  # [A, 4]
    prototype = prediction.mask_prototype       # [B, h, w, P]
    sets = match_anchors(prediction, truth, model_config, train_config)
    positive, match_index = sets.positive, sets.match_index
    n_pos = positive.sum()
    n_pos_f = torch.clamp_min(n_pos.float(), 1.0)

    # ---- classification -------------------------------------------------
    with torch.no_grad():
        match_cls = torch.gather(truth.classification.long(), 1, match_index)
        match_cls = torch.where(positive, match_cls, torch.zeros_like(match_cls))
    ce = softmax_cross_entropy(classification, match_cls)  # [B, A]
    cls_sum = (sets.selected.float() * ce).sum()
    l_cls = torch.where(n_pos > 0, cls_sum / ((1 + cfg.negative_example_ratio) * n_pos_f),
                        cls_sum)

    # ---- box regression -------------------------------------------------
    with torch.no_grad():
        matched_box = _gather_rows(truth.box, match_index)  # [B, A, 4]
        anchor_b = anchor[None].expand_as(matched_box)
        safe_box = torch.where(positive[..., None], matched_box, anchor_b)
        enc_target = box_encode(safe_box, anchor_b, cfg.box_variances)
    diff = torch.abs(box_encoding - enc_target)
    sl1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5)
    box_sum = (positive[..., None].float() * sl1).sum()
    l_box = torch.where(n_pos > 0, box_sum / n_pos_f, box_sum)

    # ---- mask -----------------------------------------------------------
    proto_hw = tuple(prototype.shape[1:3])
    n_objects = truth.box.shape[1]
    with torch.no_grad():
        obj_ids = torch.arange(n_objects, device=truth.seg_map.device)
        inst = (truth.seg_map[:, None] == obj_ids[None, :, None, None]).float()
        inst_resized = resize_bilinear(inst, proto_hw)     # [B, M, h, w]
        inst_area = inst_resized.sum(dim=(2, 3))            # [B, M]
        valid_resized = resize_nearest(truth.img_valid.float(), proto_hw)  # [B, h, w]
    objects = (inst_resized, inst_area, valid_resized, truth.box)

    k_cap = train_config.max_positive_anchors
    if k_cap is None:
        sums = []
        for b in range(prototype.shape[0]):
            idx = torch.nonzero(positive[b])[:, 0][None]   # [1, n_b]
            sums.append(_anchor_set_loss(
                prototype[b:b + 1], _gather_rows(mask_coeff[b:b + 1], idx),
                torch.gather(match_index[b:b + 1], 1, idx),
                torch.ones_like(idx, dtype=torch.bool), *(t[b:b + 1] for t in objects)))
        mask_sum = torch.cat(sums).sum()
        clipped = torch.zeros((), dtype=torch.int64, device=prototype.device)
    else:
        mask_sum = _anchor_set_loss(
            prototype, _gather_rows(mask_coeff, sets.top_anchor),
            torch.gather(match_index, 1, sets.top_anchor), sets.top_valid, *objects).sum()
        clipped = torch.clamp_min(positive.sum(dim=1) - k_cap, 0).sum()
    l_mask = torch.where(n_pos > 0, mask_sum / n_pos_f, mask_sum)

    return YolactLosses(total=l_cls + l_box + l_mask, classification=l_cls, box=l_box,
                        mask=l_mask, mask_clipped=clipped)
