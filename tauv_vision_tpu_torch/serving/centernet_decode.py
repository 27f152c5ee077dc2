"""CenterNet decode into fixed-size detection tensors (counterpart of
``decode`` and ``Detections`` in ``tauv_vision_tpu/serving/centernet_decode.py``).

Angle, depth and keypoint heads are not ported yet: ``decode`` raises
``NotImplementedError`` for a ``Prediction`` that carries them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tauv_vision_tpu_torch.configs.centernet import CenternetModelConfig
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.ops.heatmap import gather_at_cells
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda

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

    yaw: Optional[torch.Tensor] = None
    pitch: Optional[torch.Tensor] = None
    roll: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None


_UNPORTED_HEADS = ("keypoint_heatmap", "yaw_bin", "pitch_bin", "roll_bin", "depth")


def decode(
    prediction: Prediction,
    model_config: CenternetModelConfig,
    n_detections: int,
    score_threshold: float,
    impl: str = "kernel",
) -> Detections:
    """Dense prediction maps -> top-k detections.

    ``impl="kernel"`` decodes peaks with ``peak_decode_cuda`` (kernel A on
    a CUDA tensor); ``impl="plain"`` with the plain ``peak_decode``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    carried = [n for n in _UNPORTED_HEADS if getattr(prediction, n) is not None]
    if carried:
        raise NotImplementedError(f"decode of heads {carried} is not ported yet")
    mc = model_config
    peaks = peak_decode_cuda if impl == "kernel" else peak_decode
    index, label, score = peaks(prediction.heatmap_nchw(), n_detections)

    size = gather_at_cells(prediction.size, index)      # [B, K, 2]
    offset = gather_at_cells(prediction.offset, index)  # [B, K, 2]
    iy = index[..., 0].to(torch.float32)
    ix = index[..., 1].to(torch.float32)
    y = (mc.downsample_ratio * iy + offset[..., 0]) / mc.in_h
    x = (mc.downsample_ratio * ix + offset[..., 1]) / mc.in_w
    return Detections(
        valid=score >= score_threshold, score=score, label=label,
        y=y, x=x, h=size[..., 0], w=size[..., 1],
    )
