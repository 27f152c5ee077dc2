"""Serving pipelines: uint8 camera frames -> decoded detections
(counterpart of ``tauv_vision_tpu/serving/pipeline.py``).

Each ``make_*_pipeline`` returns ``fn(img_uint8 [B, H, W, 3])`` that
uploads the frames to ``device`` (the card unless the caller passes
"cpu"), preprocesses, runs the net and decodes, under
``torch.inference_mode``.  The decode knobs live in
``SERVING_DECODE`` (the CenterNet's and the YOLACT's) and
``YOLO_POSE_DECODE`` and nowhere else.  ``dtype`` is the normalised
image's type: the JAX functions' parameter, whose default there is bf16;
the port's default is f32, and a served recipe passes its own
(``configs.NORTH_STAR.input_dtype``, ``configs.KEYPOINTS.input_dtype``,
and the int8 chains' bf16 through ``serving/quantize_chain.py``), but for
``make_yolo_pose_pipeline``, whose default is the JAX function's bf16.

``make_float_pair_pipeline`` serves the float profiles of the pair
(``configs.BF16_PAIR`` and its ladder).

``depth_window_z``, ``mask_mean_z`` and ``back_project`` turn decoded
detections and a depth image into camera-frame 3D points, for the node
servers of ``serving/nodes.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from tauv_vision_tpu_torch.configs import FloatPairRecipe
from tauv_vision_tpu_torch.configs.centernet import CenternetModelConfig, ObjectConfigSet
from tauv_vision_tpu_torch.configs.yolact import YolactModelConfig
from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.ops.image import normalize_image, preprocess, resize_frames
from tauv_vision_tpu_torch.serving.centernet_decode import decode, decode_keypoints
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact
from tauv_vision_tpu_torch.serving.yolo_pose_decode import attach_pnp, decode_yolo_pose

# ImageNet statistics, the constants both reference nodes normalise with.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STDDEV = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class DecodeKnobs:
    """Decode settings of the served path."""

    n_detections: int = 10          # CenterNet top-k
    score_threshold: float = 0.6    # CenterNet score
    keypoint_n_detections: int = 50       # CenterNet keypoint top-k
    keypoint_score_threshold: float = 0.3  # CenterNet keypoint score
    top_k: int = 20                 # YOLACT Fast-NMS candidates
    iou_threshold: float = 0.5      # YOLACT Fast-NMS overlap
    confidence_threshold: float = 0.5  # YOLACT class confidence


SERVING_DECODE = DecodeKnobs()


@dataclass(frozen=True)
class YoloPoseKnobs:
    """Decode settings of the served YOLO-Pose (``bench.py:485-490``, the
    JAX ``make_yolo_pose_pipeline``'s defaults)."""

    top_k: int = 10                 # Fast-NMS candidates
    iou_threshold: float = 0.5      # Fast-NMS overlap
    confidence_threshold: float = 0.5  # class confidence
    keypoint_score_threshold: float = 0.3  # a belief peak PnP uses


YOLO_POSE_DECODE = YoloPoseKnobs()


def _upload(img_uint8, device) -> torch.Tensor:
    if isinstance(img_uint8, np.ndarray):
        img_uint8 = torch.from_numpy(img_uint8)
    return img_uint8.to(device, non_blocking=True)


def make_centernet_pipeline(model, model_config: CenternetModelConfig,
                            device=DEFAULT_DEVICE,
                            knobs: DecodeKnobs = SERVING_DECODE,
                            impl: str = "kernel", dtype=torch.float32):
    """``fn(img_uint8) -> Detections``; ``model(img)`` takes the normalised
    NCHW image (the model itself, or a chain forward of
    ``serving/quantize_chain.py``), and is kept as ``fn.forward``."""
    device = resolve_device(device)
    out_hw = (model_config.in_h, model_config.in_w)

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = preprocess(_upload(img_uint8, device), out_hw,
                             IMAGENET_MEAN, IMAGENET_STDDEV, dtype)
            return decode(model(img), model_config, knobs.n_detections,
                          knobs.score_threshold, impl=impl)

    pipeline.forward = model
    return pipeline


def make_centernet_keypoint_pipeline(model, model_config: CenternetModelConfig,
                                     object_config: ObjectConfigSet, projection_matrix,
                                     device=DEFAULT_DEVICE,
                                     knobs: DecodeKnobs = SERVING_DECODE,
                                     impl: str = "kernel", dtype=torch.float32):
    """``fn(img_uint8) -> KeypointDetections``: the CenterNet node's full
    configuration, keypoint peaks matched to detections and PnP on the
    device.  ``projection_matrix`` ([3, 3] or [3, 4] intrinsics) is
    uploaded once, here."""
    device = resolve_device(device)
    out_hw = (model_config.in_h, model_config.in_w)
    projection = torch.as_tensor(projection_matrix, dtype=torch.float32, device=device)

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = preprocess(_upload(img_uint8, device), out_hw,
                             IMAGENET_MEAN, IMAGENET_STDDEV, dtype)
            return decode_keypoints(
                model(img), model_config, object_config, projection,
                knobs.n_detections, knobs.keypoint_n_detections,
                knobs.score_threshold, knobs.keypoint_score_threshold, impl=impl)

    return pipeline


def make_yolact_pipeline(model, model_config: YolactModelConfig,
                         device=DEFAULT_DEVICE,
                         knobs: DecodeKnobs = SERVING_DECODE,
                         impl: str = "kernel", dtype=torch.float32,
                         mask_hw: Optional[Tuple[int, int]] = None):
    """``fn(img_uint8) -> YolactDetections``; ``model(img)`` takes the
    normalised NCHW image (the model itself, or a chain forward of
    ``serving/quantize_chain.py``), and is kept as ``fn.forward``.
    ``mask_hw`` resizes the decoded masks (``decode_yolact``)."""
    device = resolve_device(device)
    out_hw = (model_config.in_h, model_config.in_w)

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = preprocess(_upload(img_uint8, device), out_hw,
                             model_config.img_mean, model_config.img_stddev, dtype)
            return decode_yolact(model(img), model_config, knobs.top_k,
                                 knobs.iou_threshold,
                                 knobs.confidence_threshold, mask_hw=mask_hw,
                                 impl=impl)

    pipeline.forward = model
    return pipeline


def make_yolo_pose_pipeline(model, model_config: YoloPoseModelConfig,
                            object_points=None, camera_matrix=None,
                            device=DEFAULT_DEVICE,
                            knobs: YoloPoseKnobs = YOLO_POSE_DECODE,
                            impl: str = "kernel", dtype=torch.bfloat16):
    """``fn(img_uint8) -> YoloPoseDetections``: belief-peak keypoints, and
    each detection's pose when ``object_points`` ([Kp, 3]) and
    ``camera_matrix`` ([3, 3]) are given (uploaded once, here): PnP runs
    over the decoded keypoints (``attach_pnp``), the math of the JAX
    function's fused branch.  ``model(img)`` takes the normalised NCHW
    image."""
    device = resolve_device(device)
    out_hw = (model_config.in_h, model_config.in_w)
    want_pnp = object_points is not None and camera_matrix is not None
    if want_pnp:
        object_points, camera_matrix = (
            torch.as_tensor(np.asarray(a, np.float32), device=device)
            for a in (object_points, camera_matrix))

    def pipeline(img_uint8):
        with torch.inference_mode():
            img = preprocess(_upload(img_uint8, device), out_hw,
                             IMAGENET_MEAN, IMAGENET_STDDEV, dtype)
            dets = decode_yolo_pose(model(img), model_config, knobs.top_k,
                                    knobs.iou_threshold, knobs.confidence_threshold,
                                    impl=impl)
            if want_pnp:
                dets = attach_pnp(dets, model_config, object_points, camera_matrix,
                                  knobs.keypoint_score_threshold)
            return dets

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


def make_float_pair_pipeline(recipe: FloatPairRecipe, cn, cn_model_config: CenternetModelConfig,
                             yl, device=DEFAULT_DEVICE, knobs: DecodeKnobs = SERVING_DECODE,
                             impl: str = "kernel"):
    """``fn(img_uint8) -> (Detections, YolactDetections)``: a float
    profile of the pair (``configs.BF16_PAIR``, its ladder
    ``configs.bf16_pair``) on the CenterNet ``cn`` built from
    ``recipe.centernet`` and the YOLACT ``yl`` built in
    ``recipe.yolact_dtype``.  Unfused, the two requests ``bench.py`` times
    (``make_centernet_pipeline`` on the image in ``recipe.input_dtype``,
    ``make_yolact_pipeline`` on its own), kept as ``fn.requests``; with
    ``recipe.fused``, one ``make_combined_pipeline`` that shares the
    resize."""
    if recipe.fused:
        return make_combined_pipeline(cn, cn_model_config, yl, yl.config, device, knobs, impl,
                                      dtype=recipe.input_dtype)
    requests = (make_centernet_pipeline(cn, cn_model_config, device, knobs, impl,
                                        dtype=recipe.input_dtype),
                make_yolact_pipeline(yl, yl.config, device, knobs, impl,
                                     dtype=recipe.yolact_dtype))

    def pipeline(img_uint8):
        return tuple(request(img_uint8) for request in requests)

    pipeline.requests = requests
    return pipeline


def depth_window_z(depth_img: torch.Tensor, centers_px: torch.Tensor,
                   window: int = 5) -> torch.Tensor:
    """Mean of the valid depths in a window around each centre.

    Args:
      depth_img: [B, H, W] depth in metres (0 or NaN = invalid).
      centers_px: [B, K, 2] integer (y, x) pixel centres.
    Returns: [B, K] z estimates (NaN where the window has no valid depth).
    """
    b, h, w = depth_img.shape
    k = centers_px.shape[1]
    half = window // 2
    offs = torch.arange(-half, half + 1, device=depth_img.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ys = torch.clamp(centers_px[..., 0:1].long() + oy.reshape(-1), 0, h - 1)  # [B, K, W2]
    xs = torch.clamp(centers_px[..., 1:2].long() + ox.reshape(-1), 0, w - 1)
    vals = torch.gather(depth_img.reshape(b, h * w), 1,
                        (ys * w + xs).reshape(b, -1)).reshape(b, k, -1)
    valid = torch.isfinite(vals) & (vals > 0)
    count = valid.sum(-1)
    mean = torch.where(valid, vals, 0.0).sum(-1) / torch.clamp_min(count, 1)
    return torch.where(count > 0, mean, torch.nan)


def mask_mean_z(depth_img: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Mean depth inside each detection mask, nanmean(depth[mask > 0.5]).

    Args:
      depth_img: [B, H, W]; masks: [B, K, H, W].
    Returns: [B, K].
    """
    depth = depth_img[:, None]
    inside = (masks > 0.5) & torch.isfinite(depth) & (depth > 0)
    count = inside.sum((-1, -2))
    total = torch.where(inside, depth, 0.0).sum((-1, -2))
    return torch.where(count > 0, total / torch.clamp_min(count, 1), torch.nan)


def back_project(y_norm: torch.Tensor, x_norm: torch.Tensor, z: torch.Tensor,
                 intrinsics: torch.Tensor, img_hw: Tuple[int, int]) -> torch.Tensor:
    """Pinhole back-projection of normalised image coordinates and depth
    to camera-frame points [..., 3] (x, y, z)."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    h, w = img_hw
    u = x_norm * w
    v = y_norm * h
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return torch.stack((x, y, z), dim=-1)
