"""Synthetic square data (counterpart of ``tauv_vision_tpu/data/synthetic.py``):
rotated squares painted on noise, labelled with centre, size, yaw modulo
pi/2 and, optionally, the four corners as keypoints
(``generate_square_batch``, the CenterNet's), and axis-aligned coloured
squares with their instance segmentation (``generate_square_seg_batch``,
the YOLACT's).  Numpy on the host, bit-equal to the JAX package's on the
same generator; the batch goes to the device at the step (``.to``).
``write_square_pose_dataset`` and ``write_square_seg_dataset`` write such
squares as dataset directories, for the training CLIs' readers, and
``write_square_fat_dataset`` writes projected cubes as a Falling Things
tree, for the YOLO-Pose CLI's.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from math import pi
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from tauv_vision_tpu_torch.configs.centernet import AngleConfig, ObjectConfig, ObjectConfigSet
from tauv_vision_tpu_torch.data.dataset_dir import (
    DatasetSample,
    write_classes,
    write_meta,
    write_sample,
    write_splits,
)
from tauv_vision_tpu_torch.data.dataset_dir import BACKGROUND_SEG
from tauv_vision_tpu_torch.data.falling_things import (
    FallingThingsEnvironment,
    FallingThingsObject,
    FallingThingsVariant,
)
from tauv_vision_tpu_torch.train.centernet_task import CenternetTruth
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth


@dataclass
class SquareDatasetConfig:
    in_h: int = 64
    in_w: int = 64
    max_objects: int = 2
    min_side: int = 10
    max_side: int = 24
    noise_level: float = 0.3
    rotate: bool = True
    keypoints: bool = False  # emit the 4 square corners as keypoints


# Unit-square corner offsets ((y, x) in half-side units, object frame): the
# 4 keypoints of an object, in a fixed order so that the flat keypoint
# index is defined.
SQUARE_CORNERS = ((-0.5, -0.5), (-0.5, 0.5), (0.5, 0.5), (0.5, -0.5))


def square_object_config(keypoints: bool = True) -> ObjectConfigSet:
    """The objects of the synthetic squares: one class ``square``, its yaw
    trained modulo pi/2 (a square turned by a quarter looks the same), no
    roll, pitch or depth, and (``keypoints``) the 4 corners as keypoints
    (y, x, 0) in ``SQUARE_CORNERS`` order."""
    return ObjectConfigSet(configs=(ObjectConfig(
        id="square",
        yaw=AngleConfig(train=True, modulo=pi / 2),
        pitch=AngleConfig(train=False, modulo=None),
        roll=AngleConfig(train=False, modulo=None),
        train_depth=False,
        train_keypoints=keypoints,
        keypoints=tuple((y, x, 0.0) for y, x in SQUARE_CORNERS) if keypoints else None,
    ),))


def _paint_square(img: np.ndarray, cy: float, cx: float, side: float, theta: float) -> None:
    h, w, _ = img.shape
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dy = y - cy
    dx = x - cx
    ry = np.cos(theta) * dy - np.sin(theta) * dx
    rx = np.sin(theta) * dy + np.cos(theta) * dx
    inside = (np.abs(ry) <= side / 2) & (np.abs(rx) <= side / 2)
    img[inside] = 1.0


def generate_square_batch(
    rng: np.random.Generator,
    batch_size: int,
    config: Optional[SquareDatasetConfig] = None,
) -> Tuple[np.ndarray, CenternetTruth]:
    """(img [B, H, W, 3] f32 in [0, 1], truth of numpy arrays)."""
    cfg = config or SquareDatasetConfig()
    h, w, n = cfg.in_h, cfg.in_w, cfg.max_objects

    img = rng.uniform(0, cfg.noise_level, (batch_size, h, w, 3)).astype(np.float32)
    valid = np.zeros((batch_size, n), bool)
    label = np.zeros((batch_size, n), np.int32)
    center = np.zeros((batch_size, n, 2), np.float32)
    size = np.zeros((batch_size, n, 2), np.float32)
    yaw = np.zeros((batch_size, n), np.float32)
    k_slots = 4 * n
    kp_valid = np.zeros((batch_size, k_slots), bool)
    kp_label = np.zeros((batch_size, k_slots), np.int32)
    kp_center = np.zeros((batch_size, k_slots, 2), np.float32)
    kp_object = np.zeros((batch_size, k_slots), np.int32)

    for b in range(batch_size):
        n_objects = int(rng.integers(1, n + 1))
        for i in range(n_objects):
            side = float(rng.uniform(cfg.min_side, cfg.max_side))
            margin = side
            cy = float(rng.uniform(margin, h - margin))
            cx = float(rng.uniform(margin, w - margin))
            theta = float(rng.uniform(0, pi / 2)) if cfg.rotate else 0.0

            _paint_square(img[b], cy, cx, side, theta)

            valid[b, i] = True
            center[b, i] = (cy / h, cx / w)
            # The axis-aligned extent of a rotated square.
            extent = side * (abs(np.cos(theta)) + abs(np.sin(theta)))
            size[b, i] = (extent / h, extent / w)
            yaw[b, i] = theta

            if cfg.keypoints:
                # Corners in SQUARE_CORNERS order, rotated into image
                # coordinates (the inverse of _paint_square's rotation).
                ct, st = np.cos(theta), np.sin(theta)
                for ki, (ry, rx) in enumerate(SQUARE_CORNERS):
                    dy = (ct * ry + st * rx) * side
                    dx = (-st * ry + ct * rx) * side
                    slot = 4 * i + ki
                    kp_valid[b, slot] = True
                    kp_label[b, slot] = ki  # the flat keypoint index (1 class)
                    kp_center[b, slot] = ((cy + dy) / h, (cx + dx) / w)
                    kp_object[b, slot] = i

    truth = CenternetTruth(
        valid=valid,
        label=label,
        center=center,
        size=size,
        yaw=yaw,
        roll=np.zeros_like(yaw),
        pitch=np.zeros_like(yaw),
        depth=np.ones_like(yaw),
        keypoint_valid=kp_valid if cfg.keypoints else None,
        keypoint_label=kp_label if cfg.keypoints else None,
        keypoint_center=kp_center if cfg.keypoints else None,
        keypoint_object_index=kp_object if cfg.keypoints else None,
    )
    return img, truth


def generate_square_seg_batch(
    rng: np.random.Generator,
    batch_size: int,
    config: Optional[SquareDatasetConfig] = None,
):
    """Synthetic instance-segmentation batch: axis-aligned squares of random
    colour on noise, placed without overlap (10 attempts each), with the
    instance seg map in the dataset-directory convention (object index per
    pixel, 255 background).

    Returns ``(img [B, H, W, 3] f32, fields)``, fields a dict of numpy
    arrays: valid [B, M], classification [B, M] (1, the square class),
    box [B, M, 4] normalised (y, x, h, w), seg [B, H, W] uint8 and
    img_valid [B, H, W] bool (all True); ``seg_truth`` makes the
    ``YolactTruth``."""
    cfg = config or SquareDatasetConfig()
    h, w, n = cfg.in_h, cfg.in_w, cfg.max_objects

    img = rng.uniform(0, cfg.noise_level, (batch_size, h, w, 3)).astype(np.float32)
    seg = np.full((batch_size, h, w), BACKGROUND_SEG, np.uint8)
    valid = np.zeros((batch_size, n), bool)
    classification = np.zeros((batch_size, n), np.int32)
    box = np.zeros((batch_size, n, 4), np.float32)

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for b in range(batch_size):
        n_objects = int(rng.integers(1, n + 1))
        placed = 0
        for _ in range(n_objects):
            # Reject overlapping placements, so each instance's box stays
            # consistent with its whole mask.
            for _attempt in range(10):
                side = float(rng.uniform(cfg.min_side, cfg.max_side))
                cy = float(rng.uniform(side, h - side))
                cx = float(rng.uniform(side, w - side))
                inside = (np.abs(ys - cy) <= side / 2) & (np.abs(xs - cx) <= side / 2)
                if (seg[b][inside] == BACKGROUND_SEG).all():
                    break
            else:
                continue
            color = rng.uniform(0.5, 1.0, 3).astype(np.float32)
            img[b][inside] = color
            seg[b][inside] = placed
            valid[b, placed] = True
            classification[b, placed] = 1
            box[b, placed] = (cy / h, cx / w, side / h, side / w)
            placed += 1

    return img, {
        "valid": valid,
        "classification": classification,
        "box": box,
        "seg": seg,
        "img_valid": np.ones((batch_size, h, w), bool),
    }


def seg_truth(fields: dict) -> YolactTruth:
    """The ``YolactTruth`` (numpy) of ``generate_square_seg_batch``'s fields."""
    return YolactTruth(valid=fields["valid"], classification=fields["classification"],
                       box=fields["box"], seg_map=fields["seg"].astype(np.int32),
                       img_valid=fields["img_valid"])


def square_pose_samples(rng: np.random.Generator, n: int, h: int, w: int,
                        labels: Sequence[str], max_objects: int = 4,
                        min_side: float = 8.0, max_side: float = 24.0,
                        focal: float = 100.0, distance: float = 2.0) -> List[DatasetSample]:
    """``n`` on-disk samples (``data/dataset_dir.py``'s contract) of 1 to
    ``max_objects`` rotated squares painted on noise, as uint8 [h, w, 3]
    frames: each square an object of a label drawn from ``labels``, its
    box the square's axis-aligned extent, its pose a yaw and a
    ``cam_t_object`` whose translation projects the object's origin (the
    one keypoint of ``configs/samples_torpedo.py``'s objects) onto the
    square's centre through the sample's pinhole camera (focal length
    ``focal`` pixels, principal point at the frame's centre)."""
    projection = [[focal, 0.0, w / 2, 0.0], [0.0, focal, h / 2, 0.0], [0.0, 0.0, 1.0, 0.0]]
    samples = []
    for i in range(n):
        img = rng.uniform(0, 0.3, (h, w, 3)).astype(np.float32)
        objects = []
        for _ in range(int(rng.integers(1, max_objects + 1))):
            side = float(rng.uniform(min_side, max_side))
            cy, cx = float(rng.uniform(side, h - side)), float(rng.uniform(side, w - side))
            theta = float(rng.uniform(0, pi / 2))
            _paint_square(img, cy, cx, side, theta)
            extent = side * (abs(np.cos(theta)) + abs(np.sin(theta)))
            t = ((cx - w / 2) * distance / focal, (cy - h / 2) * distance / focal, distance)
            objects.append({
                "label": labels[int(rng.integers(len(labels)))],
                "bbox": {"x": cx / w, "y": cy / h, "w": extent / w, "h": extent / h},
                "pose": {"roll": 0.0, "pitch": 0.0, "yaw": theta, "distance": distance,
                         "cam_t_object": [1.0, 0.0, 0.0, t[0], 0.0, 1.0, 0.0, t[1],
                                          0.0, 0.0, 1.0, t[2], 0.0, 0.0, 0.0, 1.0]},
            })
        samples.append(DatasetSample(
            id=f"{i:06d}", img=np.round(img * 255).astype(np.uint8), objects=objects,
            camera={"h": h, "w": w, "projection": projection}))
    return samples


def write_square_pose_dataset(root: pathlib.Path, rng: np.random.Generator, n_train: int,
                              n_val: int, h: int, w: int, labels: Sequence[str],
                              **kwargs) -> None:
    """A dataset directory of ``square_pose_samples``: ``n_train`` train
    and ``n_val`` val samples, their splits, classes and meta files."""
    root = pathlib.Path(root)
    samples = square_pose_samples(rng, n_train + n_val, h, w, labels, **kwargs)
    for sample in samples:
        write_sample(root / "data", sample)
    ids = [s.id for s in samples]
    write_splits(root, {"train": ids[:n_train], "val": ids[n_train:], "test": []})
    write_classes(root, list(labels))
    write_meta(root, "tauv_vision_tpu_torch", "synthetic squares", "2026-01-01T00:00:00")


def square_seg_samples(rng: np.random.Generator, n: int, h: int, w: int,
                       labels: Sequence[str], max_objects: int = 4,
                       min_side: float = 8.0, max_side: float = 24.0) -> List[DatasetSample]:
    """``n`` on-disk segmentation samples (``data/dataset_dir.py``'s
    contract, what ``SegmentationDataset`` reads): each a
    ``generate_square_seg_batch`` frame of 1 to ``max_objects`` squares as
    uint8 [h, w, 3] with its seg map, each square an object of a class
    drawn from ``labels`` with its box."""
    config = SquareDatasetConfig(in_h=h, in_w=w, max_objects=max_objects, min_side=min_side,
                                 max_side=max_side)
    samples = []
    for i in range(n):
        img, fields = generate_square_seg_batch(rng, 1, config)
        objects = [{"class_id": labels[int(rng.integers(len(labels)))],
                    "bbox": {"x": float(cx), "y": float(cy), "w": float(bw), "h": float(bh)}}
                   for cy, cx, bh, bw in fields["box"][0][fields["valid"][0]]]
        samples.append(DatasetSample(id=f"{i:06d}", img=np.round(img[0] * 255).astype(np.uint8),
                                     seg=fields["seg"][0], objects=objects))
    return samples


def write_square_seg_dataset(root: pathlib.Path, rng: np.random.Generator, n_train: int,
                             n_val: int, h: int, w: int, labels: Sequence[str],
                             **kwargs) -> None:
    """A dataset directory of ``square_seg_samples`` ({id}.png,
    {id}_seg.png, {id}.json): ``n_train`` train and ``n_val`` val samples,
    their splits, classes and meta files."""
    root = pathlib.Path(root)
    samples = square_seg_samples(rng, n_train + n_val, h, w, labels, **kwargs)
    for sample in samples:
        write_sample(root / "data", sample)
    ids = [s.id for s in samples]
    write_splits(root, {"train": ids[:n_train], "val": ids[n_train:], "test": []})
    write_classes(root, list(labels))
    write_meta(root, "tauv_vision_tpu_torch", "synthetic squares", "2026-01-01T00:00:00")


# The Falling Things exporter's intrinsics of its 960x540 frames
# (``_camera_settings.json``), scaled with the frame by the writer.
FAT_INTRINSICS = (768.1605834960938, 768.1605834960938, 480.0, 270.0)
FAT_SIZE = (540, 960)
FAT_SEG_ID = 12          # the exporter's segmentation id of the one object
FAT_OBJECT = FallingThingsObject.MustardBottle   # the CLI's --object default
FAT_SIDE = (0.1, 0.3)            # a cube's side, in frame heights at its depth
FAT_DEPTH_CM = (40.0, 90.0)
# A cube's corners in its own frame, in half-sides.
CUBE_CORNERS = tuple((x, y, z) for x in (1, -1) for y in (1, -1) for z in (1, -1))


def _quat_xyzw_about_z(theta: float) -> List[float]:
    return [0.0, 0.0, float(np.sin(theta / 2)), float(np.cos(theta / 2))]


def _fat_intrinsics(h: int, w: int) -> Tuple[float, float, float, float]:
    fx, fy, cx, cy = FAT_INTRINSICS
    return fx * w / FAT_SIZE[1], fy * h / FAT_SIZE[0], cx * w / FAT_SIZE[1], cy * h / FAT_SIZE[0]


def _fat_cube_frame(rng: np.random.Generator, h: int, w: int, n_objects: int):
    """One Falling Things frame of ``n_objects`` cubes of ``FAT_OBJECT``
    planted in the camera's frame (at a depth in ``FAT_DEPTH_CM``, a side
    that spans ``FAT_SIDE`` of the frame's height there, a turn about the
    optical axis), their 8 corners projected through the
    pinhole camera of ``FAT_INTRINSICS`` scaled to h x w, each painted as
    the filled extent of its projection over noise (a later cube over an
    earlier one), with the seg map (``FAT_SEG_ID`` on a cube, 0 elsewhere)
    and a 16-bit depth map (1e-4 m units).  Returns (img uint8 [h, w, 3],
    seg uint8 [h, w], depth uint16 [h, w], the ``.left.json`` dict)."""
    fx, fy, cx, cy = _fat_intrinsics(h, w)
    img = rng.integers(0, 77, (h, w, 3), np.uint8)
    seg = np.zeros((h, w), np.uint8)
    depth = np.full((h, w), 30000, np.uint16)
    objects = []
    for _ in range(n_objects):
        side_px = float(rng.uniform(*FAT_SIDE)) * h
        z = float(rng.uniform(*FAT_DEPTH_CM))
        side_cm = side_px * z / fy
        # The centre's projection lands a side inside the frame, so that
        # the turned cube's projection stays inside.
        u = float(rng.uniform(side_px, w - side_px))
        v = float(rng.uniform(side_px, h - side_px))
        location = np.array([(u - cx) * z / fx, (v - cy) * z / fy, z])
        theta = float(rng.uniform(0, np.pi / 2))
        rot = np.array([[np.cos(theta), -np.sin(theta), 0.0],
                        [np.sin(theta), np.cos(theta), 0.0], [0.0, 0.0, 1.0]])
        cuboid = location + (np.asarray(CUBE_CORNERS) * side_cm / 2) @ rot.T    # [8, 3] cm
        projected = np.stack([fx * cuboid[:, 0] / cuboid[:, 2] + cx,
                              fy * cuboid[:, 1] / cuboid[:, 2] + cy], axis=-1)  # (x, y)
        x0, y0 = projected.min(axis=0)
        x1, y1 = projected.max(axis=0)
        rows, cols = slice(int(np.floor(y0)), int(np.ceil(y1))), slice(int(np.floor(x0)),
                                                                         int(np.ceil(x1)))
        img[rows, cols] = rng.integers(128, 256, 3, np.uint8)
        seg[rows, cols] = FAT_SEG_ID
        depth[rows, cols] = int(round(z * 100))      # cm -> 1e-4 m
        objects.append({
            "class": FAT_OBJECT.value.upper(),   # the reader lower-cases the class
            "location": location.tolist(),
            "quaternion_xyzw": _quat_xyzw_about_z(theta),
            "bounding_box": {"top_left": [float(y0), float(x0)],
                             "bottom_right": [float(y1), float(x1)]},
            "cuboid_centroid": location.tolist(),
            "projected_cuboid_centroid": [u, v],
            "cuboid": cuboid.tolist(),
            "projected_cuboid": projected.tolist(),
        })
    left = {"camera_data": {"location_worldframe": rng.uniform(-200, 200, 3).tolist(),
                            "quaternion_xyzw_worldframe": [0.0, 0.0, 0.0, 1.0]},
            "objects": objects}
    return img, seg, depth, left


def write_square_fat_dataset(root: pathlib.Path, rng: np.random.Generator, n_frames: int,
                             h: int, w: int,
                             environments: Sequence[FallingThingsEnvironment] = (
                                 FallingThingsEnvironment.Kitchen0,),
                             max_objects: int = 1, empty: Sequence[int] = ()) -> None:
    """A Falling Things tree (``single/<FAT_OBJECT>/<env>/``) of ``n_frames``
    ``_fat_cube_frame`` frames in each of ``environments``, each of 1 to
    ``max_objects`` cubes, the frames whose index is in ``empty`` with no
    object: ``NNNNNN.left.jpg``, ``.left.seg.png``, ``.left.depth.png``
    and ``.left.json``, beside each environment's
    ``_camera_settings.json`` and ``_object_settings.json``.  The other
    environments' directories are made empty: the YOLO-Pose CLI reads
    every environment."""
    fx, fy, cx, cy = _fat_intrinsics(h, w)
    for env in FallingThingsEnvironment:
        directory = (pathlib.Path(root) / FallingThingsVariant.SINGLE.value
                     / FAT_OBJECT.value / env.value)
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / "_camera_settings.json", "w") as fp:
            json.dump({"camera_settings": [{
                "name": "left", "horizontal_fov": 64,
                "intrinsic_settings": {"fx": fx, "fy": fy, "cx": cx, "cy": cy, "s": 0},
                "captured_image_size": {"width": w, "height": h}}]}, fp)
        with open(directory / "_object_settings.json", "w") as fp:
            json.dump({"exported_object_classes": [FAT_OBJECT.value],
                       "exported_objects": [{"class": FAT_OBJECT.value,
                                             "segmentation_class_id": FAT_SEG_ID}]}, fp)
        for i in range(n_frames if env in environments else 0):
            n = 0 if i in empty else int(rng.integers(1, max_objects + 1))
            img, seg, depth, left = _fat_cube_frame(rng, h, w, n)
            stem = directory / f"{i:06d}"
            Image.fromarray(img).save(stem.with_suffix(".left.jpg"), format="JPEG")
            Image.fromarray(seg).save(stem.with_suffix(".left.seg.png"), format="PNG")
            Image.fromarray(depth).save(stem.with_suffix(".left.depth.png"), format="PNG")
            with open(stem.with_suffix(".left.json"), "w") as fp:
                json.dump(left, fp)
