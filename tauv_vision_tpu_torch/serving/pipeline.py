"""Serving pipelines: uint8 camera frames -> decoded detections
(counterpart of ``tauv_vision_tpu/serving/pipeline.py``).

Each ``make_*_pipeline`` returns ``fn(img_uint8 [B, H, W, 3])`` that
uploads the frames to ``device`` (the card unless the caller passes
"cpu"), preprocesses, runs the net and decodes, under
``torch.inference_mode``.  The decode knobs live in
``SERVING_DECODE`` and nowhere else.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tauv_vision_tpu_torch.configs.centernet import CenternetModelConfig
from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.ops.image import normalize_image, preprocess, resize_frames
from tauv_vision_tpu_torch.serving.centernet_decode import decode
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact

# ImageNet statistics, the constants both reference nodes normalise with.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STDDEV = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DecodeKnobs:
    """Decode settings of the served path."""

    n_detections: int = 10          # CenterNet top-k
    score_threshold: float = 0.6    # CenterNet score
    top_k: int = 20                 # YOLACT Fast-NMS candidates
    iou_threshold: float = 0.5      # YOLACT Fast-NMS overlap
    confidence_threshold: float = 0.5  # YOLACT class confidence


SERVING_DECODE = DecodeKnobs()


def _upload(img_uint8, device) -> torch.Tensor:
    if isinstance(img_uint8, np.ndarray):
        img_uint8 = torch.from_numpy(img_uint8)
    return img_uint8.to(device, non_blocking=True)


def make_centernet_pipeline(model, model_config: CenternetModelConfig,
                            device=DEFAULT_DEVICE,
                            knobs: DecodeKnobs = SERVING_DECODE,
                            impl: str = "kernel"):
    """``fn(img_uint8) -> Detections``."""
    device = resolve_device(device)
    out_hw = (model_config.in_h, model_config.in_w)

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = preprocess(_upload(img_uint8, device), out_hw,
                             IMAGENET_MEAN, IMAGENET_STDDEV)
            return decode(model(img), model_config, knobs.n_detections,
                          knobs.score_threshold, impl=impl)

    return pipeline


def make_yolact_pipeline(model, model_config: YolactModelConfig,
                         device=DEFAULT_DEVICE,
                         knobs: DecodeKnobs = SERVING_DECODE,
                         impl: str = "kernel"):
    """``fn(img_uint8) -> YolactDetections``; ``model(img)`` takes the
    normalised NCHW f32 image (the model itself, or a chain forward of
    ``serving/quantize_chain.py``)."""
    device = resolve_device(device)
    out_hw = (model_config.in_h, model_config.in_w)

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = preprocess(_upload(img_uint8, device), out_hw,
                             model_config.img_mean, model_config.img_stddev)
            return decode_yolact(model(img), model_config, knobs.top_k,
                                 knobs.iou_threshold,
                                 knobs.confidence_threshold, impl=impl)

    return pipeline


def make_combined_pipeline(cn_forward, cn_model_config: CenternetModelConfig,
                           yl_forward, yl_model_config: YolactModelConfig,
                           device=DEFAULT_DEVICE,
                           knobs: DecodeKnobs = SERVING_DECODE,
                           impl: str = "kernel", dtype=torch.float32):
    """Both serving nets on one camera batch, sharing one bilinear resize.

    ``cn_forward(img) -> Prediction`` and ``yl_forward(img) ->
    YolactPrediction`` take normalised NCHW inputs (for example the
    models themselves, or a chain forward of ``serving/quantize_chain.py``),
    normalised in f32 and rounded to ``dtype``.  Returns ``fn(img_uint8)
    -> (Detections, YolactDetections)``.

    ``dtype`` is the JAX function's parameter, whose default there is
    bf16.  The port's default, f32, is the served recipe: the bf16
    CenterNet's f32 stem was certified on an f32 image (the JAX package's
    ``scripts/cn_f32_ladder.py``), and the bf16 default would round the
    image before that stem.  The int8 YOLACT chain is fed the same either
    way: its stem is a float conv in bf16, which casts its input."""
    device = resolve_device(device)
    if (cn_model_config.in_h, cn_model_config.in_w) != (
        yl_model_config.in_h, yl_model_config.in_w
    ):
        raise ValueError("the shared resize needs matching input sizes")
    out_hw = (cn_model_config.in_h, cn_model_config.in_w)

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = resize_frames(_upload(img_uint8, device), out_hw)
            cn_in = normalize_image(img, IMAGENET_MEAN, IMAGENET_STDDEV, dtype)
            yl_in = normalize_image(img, yl_model_config.img_mean,
                                    yl_model_config.img_stddev, dtype)
            cn_dets = decode(cn_forward(cn_in), cn_model_config,
                             knobs.n_detections, knobs.score_threshold,
                             impl=impl)
            yl_dets = decode_yolact(yl_forward(yl_in), yl_model_config,
                                    knobs.top_k, knobs.iou_threshold,
                                    knobs.confidence_threshold, impl=impl)
        return cn_dets, yl_dets

    return pipeline
