"""Host serving adapters, the ROS nodes' logic without ROS (counterpart of
``tauv_vision_tpu/serving/nodes.py``).

Per frame batch: preprocess, forward and decode on the device through the
port's pipelines, then on the host a z estimate from the depth image
(the window mean at each CenterNet centre, the mask mean of each YOLACT
detection), pinhole back-projection to camera-frame points, the PnP pose
where it is valid, the drop rule, an optional world-frame transform by a
caller's pose lookup, and ``publish``.  Transport (ROS or other) plugs in
as the callbacks.

The servers normalise the image to bf16, the JAX pipelines' default,
which the JAX package's servers serve: ``CenternetServer`` as its recipe
``configs.KEYPOINTS`` says, ``YolactServer`` as ``YOLACT_INPUT_DTYPE``
says (its f32 YOLACT casts the bf16 image back to f32).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from tauv_vision_tpu_torch.configs import KEYPOINTS
from tauv_vision_tpu_torch.configs.centernet import CenternetModelConfig, ObjectConfigSet
from tauv_vision_tpu_torch.configs.yolact import ClassConfigSet, YolactModelConfig
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from tauv_vision_tpu_torch.serving.pipeline import (
    DecodeKnobs,
    back_project,
    depth_window_z,
    make_centernet_keypoint_pipeline,
    make_yolact_pipeline,
    mask_mean_z,
)


@dataclasses.dataclass
class FeatureDetection:
    """The tauv_msgs/FeatureDetection payload (camera or world frame)."""

    tag: str
    position: np.ndarray            # [3]
    orientation: Optional[np.ndarray] = None  # [3, 3] rotation
    confidence: float = 1.0
    SE2: bool = False


PoseLookup = Callable[[], Optional[np.ndarray]]  # -> [4, 4] world_t_cam
Publisher = Callable[[List[FeatureDetection]], None]

WARMUP_FRAME = (1, 480, 640, 3)
YOLACT_INPUT_DTYPE = torch.bfloat16


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class CenternetServer:
    """CenterNet camera server: the keypoint pipeline (matcher and PnP on
    the device), its detections placed in 3D."""

    def __init__(
        self,
        model,
        model_config: CenternetModelConfig,
        object_config: ObjectConfigSet,
        intrinsics: np.ndarray,
        n_detections: int = 10,
        keypoint_n_detections: int = 50,
        score_threshold: float = 0.6,
        keypoint_score_threshold: float = 0.3,
        depth_window: int = 5,
        device=DEFAULT_DEVICE,
    ):
        self.model_config = model_config
        self.object_config = object_config
        self.device = resolve_device(device)
        self.intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                          device=self.device)
        self.depth_window = depth_window
        knobs = DecodeKnobs(n_detections=n_detections,
                            keypoint_n_detections=keypoint_n_detections,
                            score_threshold=score_threshold,
                            keypoint_score_threshold=keypoint_score_threshold)
        self.pipeline = make_centernet_keypoint_pipeline(
            model, model_config, object_config, self.intrinsics, self.device,
            knobs=knobs, dtype=KEYPOINTS.input_dtype)
        # Warm-up request (the node's).
        self.pipeline(np.zeros(WARMUP_FRAME, np.uint8))

    def process(
        self,
        color: np.ndarray,            # [B, H, W, 3] uint8
        depth: Optional[np.ndarray],  # [B, H, W] metres or None
        pose_lookup: Optional[PoseLookup] = None,
        publish: Optional[Publisher] = None,
    ) -> List[List[FeatureDetection]]:
        out = self.pipeline(color)
        det = out.detections
        det_y, det_x = _numpy(det.y), _numpy(det.x)
        b, k = det_y.shape
        h, w = color.shape[1:3]

        with torch.inference_mode():
            if depth is not None:
                centers_px = np.stack(
                    [
                        np.clip(det_y * h, 0, h - 1).astype(np.int32),
                        np.clip(det_x * w, 0, w - 1).astype(np.int32),
                    ],
                    axis=-1,
                )
                z = _numpy(depth_window_z(
                    torch.as_tensor(np.asarray(depth, np.float32), device=self.device),
                    torch.as_tensor(centers_px, device=self.device), self.depth_window))
            else:
                z = np.full((b, k), np.nan, np.float32)
            points = _numpy(back_project(
                torch.as_tensor(det_y, device=self.device),
                torch.as_tensor(det_x, device=self.device),
                torch.as_tensor(np.nan_to_num(z, nan=1.0), device=self.device),
                self.intrinsics, (h, w)))

        world_t_cam = pose_lookup() if pose_lookup is not None else None
        pose_valid = _numpy(out.pose_valid)
        pose_t = _numpy(out.pose_translation)
        pose_r = _numpy(out.pose_rotation)
        valid = _numpy(det.valid)
        labels = _numpy(det.label)
        scores = _numpy(det.score)

        results: List[List[FeatureDetection]] = []
        for bi in range(b):
            sample: List[FeatureDetection] = []
            for ki in range(k):
                if not valid[bi, ki]:
                    continue
                tag = self.object_config.configs[int(labels[bi, ki])].id

                if pose_valid[bi, ki]:
                    position = pose_t[bi, ki]
                    orientation = pose_r[bi, ki]
                elif np.isfinite(z[bi, ki]):
                    position = points[bi, ki]
                    orientation = None
                else:
                    continue  # no depth and no PnP: dropped, as the node does

                if world_t_cam is not None:
                    position = world_t_cam[:3, :3] @ position + world_t_cam[:3, 3]
                    if orientation is not None:
                        orientation = world_t_cam[:3, :3] @ orientation

                sample.append(FeatureDetection(
                    tag=tag, position=position, orientation=orientation,
                    confidence=float(scores[bi, ki])))
            results.append(sample)
            if publish is not None:
                publish(sample)
        return results


class YolactServer:
    """YOLACT camera server: detections placed in 3D at their mask's mean
    depth."""

    def __init__(
        self,
        model,
        model_config: YolactModelConfig,
        class_config: ClassConfigSet,
        intrinsics: np.ndarray,
        top_k: int = 20,
        iou_threshold: float = 0.5,
        confidence_threshold: float = 0.5,
        device=DEFAULT_DEVICE,
    ):
        self.model_config = model_config
        self.class_config = class_config
        self.device = resolve_device(device)
        self.intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                          device=self.device)
        knobs = DecodeKnobs(top_k=top_k, iou_threshold=iou_threshold,
                            confidence_threshold=confidence_threshold)
        self.pipeline = make_yolact_pipeline(model, model_config, self.device, knobs=knobs,
                                             dtype=YOLACT_INPUT_DTYPE)
        # Two warm-up requests (the node's).
        warmup = np.zeros(WARMUP_FRAME, np.uint8)
        self.pipeline(warmup)
        self.pipeline(warmup)

    def process(
        self,
        color: np.ndarray,
        depth: Optional[np.ndarray],
        pose_lookup: Optional[PoseLookup] = None,
        publish: Optional[Publisher] = None,
    ) -> List[List[FeatureDetection]]:
        t0 = time.perf_counter()
        out = self.pipeline(color)

        h, w = color.shape[1:3]
        b, k = out.valid.shape
        box = _numpy(out.box)
        with torch.inference_mode():
            if depth is not None:
                # The depth image sampled onto the mask grid by nearest
                # pixel, then z = nanmean(depth[mask > 0.5]).
                mh, mw = out.mask.shape[2:]
                ys = (np.arange(mh) * (h / mh)).astype(np.int32)
                xs = (np.arange(mw) * (w / mw)).astype(np.int32)
                depth_small = np.asarray(depth, np.float32)[:, ys][:, :, xs]
                z = _numpy(mask_mean_z(torch.as_tensor(depth_small, device=self.device),
                                       out.mask))
            else:
                z = np.full((b, k), np.nan, np.float32)
            points = _numpy(back_project(
                torch.as_tensor(box[..., 0], device=self.device),
                torch.as_tensor(box[..., 1], device=self.device),
                torch.as_tensor(np.nan_to_num(z, nan=1.0), device=self.device),
                self.intrinsics, (h, w)))

        world_t_cam = pose_lookup() if pose_lookup is not None else None
        valid = _numpy(out.valid)
        labels = _numpy(out.label)
        scores = _numpy(out.score)

        results: List[List[FeatureDetection]] = []
        for bi in range(b):
            sample: List[FeatureDetection] = []
            for ki in range(k):
                if not valid[bi, ki] or not np.isfinite(z[bi, ki]):
                    continue
                cfg = self.class_config.get_by_index(int(labels[bi, ki]))
                position = points[bi, ki]
                if world_t_cam is not None:
                    position = world_t_cam[:3, :3] @ position + world_t_cam[:3, 3]
                sample.append(FeatureDetection(
                    tag=cfg.id if cfg is not None else str(labels[bi, ki]),
                    position=position, confidence=float(scores[bi, ki]), SE2=False))
            results.append(sample)
            if publish is not None:
                publish(sample)
        self.last_latency = time.perf_counter() - t0
        return results
