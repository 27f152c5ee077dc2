"""YOLACT postprocess: box decode -> Fast-NMS -> mask assembly
(counterpart of ``tauv_vision_tpu/serving/yolact_decode.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig
from tauv_vision_tpu_torch.models.yolact import YolactPrediction
from tauv_vision_tpu_torch.ops.boxes import box_decode
from tauv_vision_tpu_torch.ops.image import resize_bilinear
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.nms import fast_nms

IMPLS = ("kernel", "plain")


@dataclass
class YolactDetections:
    valid: torch.Tensor    # [B, K] bool
    score: torch.Tensor    # [B, K] max non-background confidence
    label: torch.Tensor    # [B, K] int32 argmax class (1..C)
    box: torch.Tensor      # [B, K, 4] decoded (y, x, h, w)
    mask: torch.Tensor     # [B, K, mh, mw] in [0, 1]


def _take(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t [B, N, D] at index [B, K] -> [B, K, D]."""
    return torch.gather(t, 1, index[..., None].expand(-1, -1, t.shape[-1]))


def decode_yolact(
    prediction: YolactPrediction,
    config: YolactModelConfig,
    top_k: int,
    iou_threshold: float,
    confidence_threshold: float,
    mask_hw: Optional[Tuple[int, int]] = None,
    crop_masks: bool = True,
    impl: str = "kernel",
) -> YolactDetections:
    """Masks come out at prototype resolution, cropped to their boxes, or
    uncropped with ``crop_masks=False``, and resized bilinearly to
    ``mask_hw`` (``ops.image.resize_bilinear``) when it is given.

    ``impl="kernel"`` assembles masks with ``assemble_mask_cuda``
    (kernel B on a CUDA tensor; its "no crop" entry without the crop);
    ``impl="plain"`` with the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    box = box_decode(
        prediction.box_encoding, prediction.anchor[None], config.box_variances
    )
    keep_index, keep = fast_nms(
        prediction.classification, box, top_k, iou_threshold,
        confidence_threshold,
    )
    sel_box = _take(box, keep_index)
    sel_cls = _take(prediction.classification, keep_index)
    sel_coeff = _take(prediction.mask_coeff, keep_index)

    confidence = torch.softmax(sel_cls, dim=-1)[..., 1:]
    score = confidence.amax(dim=-1)
    label = confidence.argmax(dim=-1).to(torch.int32) + 1  # first maximum

    # [B, P, h, w]: the NHWC view where the prototypes were made NHWC (the
    # int8 chain), which kernel B reads in place.
    proto = prediction.mask_prototype.permute(0, 3, 1, 2)
    assemble = assemble_mask_cuda if impl == "kernel" else assemble_mask_batch
    masks = assemble(proto, sel_coeff, sel_box if crop_masks else None)
    if mask_hw is not None:
        masks = resize_bilinear(masks, mask_hw)
    return YolactDetections(
        valid=keep, score=score, label=label, box=sel_box, mask=masks
    )
