"""The canonical dataset-directory contract.

A dataset directory (SURVEY.md §1, produced at convert_replicator.py:
270-352, consumed at pose_dataset.py:61-70 and segmentation_dataset.py:
32-44) contains::

    data/{id}.png        RGB frame
    data/{id}_seg.png    instance-index seg map (255=background,
                         254=invalid-after-warp)
    data/{id}.json       camera intrinsics + per-object
                         label/bbox/pose/keypoints
    splits.json          {"splits": {"train": [...], "val": [...],
                          "test": [...]}}
    classes.json         {"classes": [...]}
    meta.json            author/description/md5/timestamp

This module reads and writes that contract: a copy of
``tauv_vision_tpu/data/dataset_dir.py`` (the reference's removed
``SegmentationSample.save`` left its writers stale; rebuilt there), its
PNGs through ``data/image_io.py``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from tauv_vision_tpu_torch.data.image_io import read_image, write_png

BACKGROUND_SEG = 255
INVALID_SEG = 254


class Split(Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"


@dataclass
class DatasetSample:
    """One on-disk sample (host-side, numpy)."""

    id: str
    img: np.ndarray                       # [H, W, 3] uint8
    seg: Optional[np.ndarray] = None      # [H, W] uint8 instance indices
    objects: List[dict] = field(default_factory=list)
    camera: Optional[dict] = None


def read_ids(root: pathlib.Path, split: Split) -> List[str]:
    with open(root / "splits.json") as fp:
        return json.load(fp)["splits"][split.value]


def read_classes(root: pathlib.Path) -> List[str]:
    with open(root / "classes.json") as fp:
        return json.load(fp)["classes"]


def read_sample(data_path: pathlib.Path, id: str, load_seg: bool = False) -> DatasetSample:
    with open((data_path / id).with_suffix(".json")) as fp:
        data = json.load(fp)
    img = read_image((data_path / id).with_suffix(".png"), channels=3)
    seg = None
    if load_seg:
        seg = read_image(data_path / f"{id}_seg.png", channels=1)
        if seg.ndim == 3:
            seg = seg[..., 0]
    return DatasetSample(
        id=id, img=img, seg=seg,
        objects=data.get("objects", []), camera=data.get("camera"),
    )


def write_sample(data_path: pathlib.Path, sample: DatasetSample) -> None:
    data_path.mkdir(parents=True, exist_ok=True)
    write_png((data_path / sample.id).with_suffix(".png"), sample.img)
    if sample.seg is not None:
        write_png(data_path / f"{sample.id}_seg.png", sample.seg)
    with open((data_path / sample.id).with_suffix(".json"), "w") as fp:
        json.dump({"objects": sample.objects, "camera": sample.camera}, fp)


def write_splits(root: pathlib.Path, splits: Dict[str, List[str]]) -> None:
    with open(root / "splits.json", "w") as fp:
        json.dump({"splits": splits}, fp, indent=2)


def write_classes(root: pathlib.Path, classes: List[str]) -> None:
    with open(root / "classes.json", "w") as fp:
        json.dump({"classes": classes}, fp, indent=2)


def dirhash(path: pathlib.Path) -> str:
    """Stable md5 over file names + contents (meta.json integrity field,
    convert_replicator.py:294)."""
    digest = hashlib.md5()
    for file in sorted(p for p in path.rglob("*") if p.is_file()):
        digest.update(str(file.relative_to(path)).encode())
        digest.update(file.read_bytes())
    return digest.hexdigest()


def write_meta(
    root: pathlib.Path,
    author: str,
    description: str,
    timestamp: str,
    human_id: Optional[str] = None,
) -> None:
    meta = {
        "author": author,
        "description": description,
        "timestamp": timestamp,
        "human_id": human_id,
        "md5": dirhash(root / "data"),
    }
    with open(root / "meta.json", "w") as fp:
        json.dump(meta, fp, indent=2)
