"""Pose dataset: dataset-dir reader for CenterNet training (a copy of
``tauv_vision_tpu/data/pose_dataset.py`` on the port's ``CenternetTruth``
and ``ObjectConfigSet.encode_keypoint_index``; the batches stay numpy
arrays on the host until the trainer moves them).

Parity target: ``datasets/load/pose_dataset.py`` —
- objects filtered to known labels (:74-77);
- 3D keypoints projected through ``cam_t_object`` and the camera
  projection, culled when off-screen (:132-147);
- boxes/keypoints/pose scalars routed through the augmentation pipeline
  (:154-179);
- center/size rebuilt from post-transform corner boxes (:190-198);
- keypoint -> object reindexing after box filtering (:212-218);
- ragged object/keypoint axes padded to a static maximum (the reference
  collate pads to the batch max, :278-354; a static shape gives every
  step the same shapes).
"""

from __future__ import annotations

import pathlib
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tauv_vision_tpu_torch.configs.centernet import ObjectConfigSet
from tauv_vision_tpu_torch.data.augment import Compose, Sample
from tauv_vision_tpu_torch.data.dataset_dir import Split, read_ids, read_sample
from tauv_vision_tpu_torch.train.centernet_task import CenternetTruth


def load_pose_sample(
    data_path: pathlib.Path,
    id: str,
    label_id_to_index: Dict[str, int],
    object_config: ObjectConfigSet,
    transform: Optional[Compose],
    rng: Optional[np.random.Generator] = None,
) -> dict:
    """Load + transform one sample into ragged numpy arrays."""
    raw = read_sample(data_path, id)
    img = raw.img
    camera = raw.camera
    cam_h, cam_w = camera["h"], camera["w"]
    projection = np.asarray(camera["projection"], np.float32).reshape(3, 4)

    objects = [o for o in raw.objects if o["label"] in label_id_to_index]

    n = len(objects)
    bboxes = np.zeros((n, 4), np.float32)  # corners (xmin, ymin, xmax, ymax)
    labels = np.zeros((n,), np.int64)
    indices = np.arange(n)
    roll = np.zeros((n,), np.float32)
    pitch = np.zeros((n,), np.float32)
    yaw = np.zeros((n,), np.float32)
    depth = np.zeros((n,), np.float32)

    keypoints: List[Tuple[float, float]] = []
    keypoint_labels: List[int] = []
    keypoint_object_indices: List[int] = []

    for i, obj in enumerate(objects):
        object_index = label_id_to_index[obj["label"]]
        labels[i] = object_index

        bb = obj["bbox"]
        corners = np.clip(
            np.asarray(
                [bb["x"] - bb["w"] / 2, bb["y"] - bb["h"] / 2,
                 bb["x"] + bb["w"] / 2, bb["y"] + bb["h"] / 2]
            ),
            0, 1,
        )
        # Degenerate boxes get a nudge (pose_dataset.py:113-118).
        if corners[0] == corners[2]:
            corners[2] = min(corners[2] + 0.01, 1.0)
        if corners[1] == corners[3]:
            corners[3] = min(corners[3] + 0.01, 1.0)
        bboxes[i] = corners

        pose = obj["pose"]
        roll[i], pitch[i], yaw[i] = pose["roll"], pose["pitch"], pose["yaw"]
        depth[i] = pose["distance"]

        config = object_config.configs[object_index]
        if config.keypoints is not None and config.train_keypoints:
            cam_t_object = np.asarray(
                pose["cam_t_object"], np.float32
            ).reshape(4, 4)
            for local_i, kp in enumerate(config.keypoints):
                kp_h = np.asarray([kp[0], kp[1], kp[2], 1.0], np.float32)
                kp_cam = cam_t_object @ kp_h
                kp_2d_h = projection @ kp_cam
                kp_2d = kp_2d_h[:2] / kp_2d_h[2]
                if 0 <= kp_2d[0] < cam_w and 0 <= kp_2d[1] < cam_h:
                    keypoints.append((float(kp_2d[0]), float(kp_2d[1])))
                    keypoint_labels.append(
                        object_config.encode_keypoint_index(object_index, local_i)
                    )
                    keypoint_object_indices.append(i)

    keypoints_np = np.asarray(keypoints, np.float32).reshape(-1, 2)
    keypoint_labels_np = np.asarray(keypoint_labels, np.int64)
    keypoint_object_indices_np = np.asarray(keypoint_object_indices, np.int64)

    if transform is not None:
        sample = Sample(
            image=img,
            bboxes=bboxes,
            bbox_fields={
                "labels": labels, "indices": indices,
                "roll": roll, "pitch": pitch, "yaw": yaw, "depth": depth,
            },
            keypoints=keypoints_np,
            keypoint_fields={
                "labels": keypoint_labels_np,
                "object_indices": keypoint_object_indices_np,
            },
        )
        out = transform(sample, rng or np.random.default_rng())
        img = out.image
        bboxes = out.bboxes
        labels = out.bbox_fields["labels"]
        indices = out.bbox_fields["indices"]
        roll = out.bbox_fields["roll"]
        pitch = out.bbox_fields["pitch"]
        yaw = out.bbox_fields["yaw"]
        depth = out.bbox_fields["depth"]
        keypoints_np = out.keypoints
        keypoint_labels_np = out.keypoint_fields["labels"]
        keypoint_object_indices_np = out.keypoint_fields["object_indices"]
        # Image size may have changed (Resize); keypoints stay in pixels
        # of the *transformed* image.
        cam_h, cam_w = img.shape[:2]

    # Rebuild center/size from (possibly transformed) corner boxes.
    center = np.stack(
        [(bboxes[:, 1] + bboxes[:, 3]) / 2, (bboxes[:, 0] + bboxes[:, 2]) / 2],
        axis=-1,
    )
    size = np.stack(
        [bboxes[:, 3] - bboxes[:, 1], bboxes[:, 2] - bboxes[:, 0]], axis=-1
    )

    # Keypoint owner indices refer to pre-filter object slots; remap to
    # surviving slot positions (pose_dataset.py:212-218).
    remapped = keypoint_object_indices_np.copy()
    keep_kp = np.zeros(len(remapped), bool)
    for kp_i, owner in enumerate(keypoint_object_indices_np):
        hits = np.nonzero(indices == owner)[0]
        if len(hits):
            remapped[kp_i] = hits[0]
            keep_kp[kp_i] = True

    keypoint_center = np.stack(
        [keypoints_np[:, 1] / cam_h, keypoints_np[:, 0] / cam_w], axis=-1
    ) if len(keypoints_np) else np.zeros((0, 2), np.float32)

    return {
        "img": img,
        "label": labels.astype(np.int32),
        "center": center.astype(np.float32),
        "size": size.astype(np.float32),
        "roll": roll.astype(np.float32),
        "pitch": pitch.astype(np.float32),
        "yaw": yaw.astype(np.float32),
        "depth": depth.astype(np.float32),
        "keypoint_center": keypoint_center[keep_kp].astype(np.float32),
        "keypoint_label": keypoint_labels_np[keep_kp].astype(np.int32),
        "keypoint_object_index": remapped[keep_kp].astype(np.int32),
    }


def collate_pose_samples(
    samples: Sequence[dict], max_objects: int, max_keypoints: int
) -> Tuple[np.ndarray, CenternetTruth]:
    """Pad ragged samples into a static [B, N]/[B, K] batch."""
    b = len(samples)
    img = np.stack([s["img"] for s in samples]).astype(np.float32) / 255.0

    def pad_obj(key, shape_tail=(), dtype=np.float32, fill=0):
        out = np.full((b, max_objects) + shape_tail, fill, dtype)
        for i, s in enumerate(samples):
            v = s[key][:max_objects]
            out[i, : len(v)] = v
        return out

    def pad_kp(key, shape_tail=(), dtype=np.float32, fill=0):
        out = np.full((b, max_keypoints) + shape_tail, fill, dtype)
        for i, s in enumerate(samples):
            v = s[key][:max_keypoints]
            out[i, : len(v)] = v
        return out

    valid = np.zeros((b, max_objects), bool)
    kp_valid = np.zeros((b, max_keypoints), bool)
    for i, s in enumerate(samples):
        valid[i, : min(len(s["label"]), max_objects)] = True
        kp_valid[i, : min(len(s["keypoint_label"]), max_keypoints)] = True

    truth = CenternetTruth(
        valid=valid,
        label=pad_obj("label", dtype=np.int32),
        center=pad_obj("center", (2,)),
        size=pad_obj("size", (2,)),
        roll=pad_obj("roll"),
        pitch=pad_obj("pitch"),
        yaw=pad_obj("yaw"),
        depth=pad_obj("depth"),
        keypoint_valid=kp_valid,
        keypoint_label=pad_kp("keypoint_label", dtype=np.int32),
        keypoint_center=pad_kp("keypoint_center", (2,)),
        keypoint_object_index=pad_kp("keypoint_object_index", dtype=np.int32),
    )
    return img, truth


class PoseDataset:
    """Index-addressable dataset over one dataset dir + split."""

    def __init__(
        self,
        root: pathlib.Path,
        split: Split,
        label_id_to_index: Dict[str, int],
        object_config: ObjectConfigSet,
        transform: Optional[Compose] = None,
        seed: int = 0,
    ):
        self.root = pathlib.Path(root)
        if not self.root.is_dir():
            raise ValueError(f"No such directory: {self.root}")
        self.data_path = self.root / "data"
        if not self.data_path.is_dir():
            raise ValueError(f"No such directory: {self.data_path}")

        self.ids = list(read_ids(self.root, split))
        random.Random(seed).shuffle(self.ids)
        self.label_id_to_index = label_id_to_index
        self.object_config = object_config
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> dict:
        return load_pose_sample(
            self.data_path, self.ids[i], self.label_id_to_index,
            self.object_config, self.transform, self._rng,
        )
