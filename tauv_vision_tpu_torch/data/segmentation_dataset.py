"""Segmentation dataset: dataset-dir reader for YOLACT training (a copy of
``tauv_vision_tpu/data/segmentation_dataset.py`` on the port's
``YolactTruth``; the batches stay numpy arrays on the host until the
trainer moves them).

Parity target: ``datasets/segmentation_dataset/segmentation_dataset.py`` —
img + instance seg png + json boxes, box clamping with the 1e-3 nudge
(:60-78), augmentation with the seg routed as a mask (:82-93), empty-image
fallback sample (:103-117), boxes converted to (y, x, h, w) (:119),
``img_valid = seg != 254`` (:100).
"""

from __future__ import annotations

import pathlib
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from tauv_vision_tpu_torch.data.augment import Compose, Sample
from tauv_vision_tpu_torch.data.dataset_dir import (
    INVALID_SEG,
    Split,
    read_ids,
    read_sample,
)
from tauv_vision_tpu_torch.train.yolact_task import YolactTruth


def load_segmentation_sample(
    data_path: pathlib.Path,
    id: str,
    class_ids_to_indices: Dict[str, int],
    transform: Optional[Compose],
    rng: Optional[np.random.Generator] = None,
) -> dict:
    raw = read_sample(data_path, id, load_seg=True)
    img = raw.img
    seg = raw.seg.astype(np.int32)

    n = len(raw.objects)
    classifications = np.zeros((n,), np.int64)
    corners = np.zeros((n, 4), np.float32)  # (xmin, ymin, xmax, ymax)

    for i, obj in enumerate(raw.objects):
        classifications[i] = class_ids_to_indices[obj["class_id"]]
        bb = obj["bbox"]
        c = np.clip(
            np.asarray(
                [bb["x"] - bb["w"] / 2, bb["y"] - bb["h"] / 2,
                 bb["x"] + bb["w"] / 2, bb["y"] + bb["h"] / 2]
            ),
            0, 1,
        )
        corners[i] = c

    # Track original object slots so seg indices can be remapped if boxes
    # are filtered by the transform.
    indices = np.arange(n)

    if transform is not None:
        out = transform(
            Sample(
                image=img, mask=seg, bboxes=corners,
                bbox_fields={
                    "classifications": classifications, "indices": indices
                },
            ),
            rng or np.random.default_rng(),
        )
        img = out.image
        seg = out.mask
        corners = out.bboxes
        classifications = out.bbox_fields["classifications"]
        indices = out.bbox_fields["indices"]

    img_valid = seg != INVALID_SEG

    if len(corners) == 0:
        # Empty-image fallback (segmentation_dataset.py:103-117).
        return {
            "img": img,
            "seg": seg,
            "img_valid": img_valid,
            "valid": np.asarray([False]),
            "classifications": np.zeros((1,), np.int32),
            "boxes": np.zeros((1, 4), np.float32),
        }

    # Clamp into (1e-3, 1-1e-3) as (x, y, w, h) like the reference, then
    # swap to the canonical (y, x, h, w).
    xywh = np.stack(
        [
            (corners[:, 0] + corners[:, 2]) / 2,
            (corners[:, 1] + corners[:, 3]) / 2,
            corners[:, 2] - corners[:, 0],
            corners[:, 3] - corners[:, 1],
        ],
        axis=-1,
    )
    xywh = np.clip(xywh, 1e-3, 1 - 1e-3)
    boxes = xywh[:, [1, 0, 3, 2]]

    # Remap seg object indices to surviving slot order.
    remapped_seg = seg.copy()
    for new_i, old_i in enumerate(indices):
        if new_i != old_i:
            remapped_seg[seg == old_i] = new_i

    return {
        "img": img,
        "seg": remapped_seg,
        "img_valid": img_valid,
        "valid": np.ones((len(boxes),), bool),
        "classifications": classifications.astype(np.int32),
        "boxes": boxes.astype(np.float32),
    }


def collate_segmentation_samples(
    samples: Sequence[dict], max_objects: int
) -> Tuple[np.ndarray, YolactTruth]:
    """Pad to a static [B, M] batch (the reference pads to the batch max
    and clamps boxes, yolact/scripts/train.py:123-156)."""
    b = len(samples)
    img = np.stack([s["img"] for s in samples]).astype(np.float32) / 255.0
    seg = np.stack([s["seg"] for s in samples]).astype(np.int32)
    img_valid = np.stack([s["img_valid"] for s in samples])

    valid = np.zeros((b, max_objects), bool)
    classifications = np.zeros((b, max_objects), np.int32)
    boxes = np.zeros((b, max_objects, 4), np.float32)
    boxes[..., 2:] = 1e-3  # keep padded boxes non-degenerate

    for i, s in enumerate(samples):
        m = min(len(s["boxes"]), max_objects)
        valid[i, :m] = s["valid"][:m]
        classifications[i, :m] = s["classifications"][:m]
        boxes[i, :m] = s["boxes"][:m]

    truth = YolactTruth(
        valid=valid,
        classification=classifications,
        box=boxes,
        seg_map=seg,
        img_valid=img_valid,
    )
    return img, truth


class SegmentationDataset:
    def __init__(
        self,
        root: pathlib.Path,
        split: Split,
        class_ids_to_indices: Dict[str, int],
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
        self.class_ids_to_indices = class_ids_to_indices
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, i: int) -> dict:
        return load_segmentation_sample(
            self.data_path, self.ids[i], self.class_ids_to_indices,
            self.transform, self._rng,
        )
