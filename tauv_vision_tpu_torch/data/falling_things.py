"""NVIDIA Falling Things (FAT) reader (a copy of
``tauv_vision_tpu/data/falling_things.py``: the same samples, field for
field, from the same files).

The single and mixed variants over per-environment scene directories;
per frame the camera intrinsics, 2D boxes normalised to (y, x, h, w), 3D
cuboids, and projected cuboids flipped to (y, x) with the 2D box centre
put in front; seg maps remapped from the exporter's segmentation ids to
class ids, in ``exported_objects`` order; depth / 1e4 in metres;
locations from cm to m.  An empty frame is skipped for the next one,
iteratively.

Host-side numpy.  The ``.jpg``, the seg ``.png`` and the 16-bit depth
``.png`` are read through PIL, as ``data/image_io.py`` reads images.
"""

from __future__ import annotations

import json
import pathlib
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
from PIL import Image


class FallingThingsVariant(Enum):
    SINGLE = "single"
    MIXED = "mixed"


class FallingThingsEnvironment(Enum):
    Kitchen0 = "kitchen_0"
    Kitchen1 = "kitchen_1"
    Kitchen2 = "kitchen_2"
    Kitchen3 = "kitchen_3"
    Kitchen4 = "kitchen_4"
    KiteDemo0 = "kitedemo_0"
    KiteDemo1 = "kitedemo_1"
    KiteDemo2 = "kitedemo_2"
    KiteDemo3 = "kitedemo_3"
    KiteDemo4 = "kitedemo_4"
    Temple0 = "temple_0"
    Temple1 = "temple_1"
    Temple2 = "temple_2"
    Temple3 = "temple_3"
    Temple4 = "temple_4"


class FallingThingsObject(Enum):
    MasterChefCan = "002_master_chef_can_16k"
    CrackerBox = "003_cracker_box_16k"
    SugarBox = "004_sugar_box_16k"
    TomatoSoupCan = "005_tomato_soup_can_16k"
    MustardBottle = "006_mustard_bottle_16k"
    TunaFishCan = "007_tuna_fish_can_16k"
    PuddingBox = "008_pudding_box_16k"
    GelatinBox = "009_gelatin_box_16k"
    PottedMeatCan = "010_potted_meat_can_16k"
    Banana = "011_banana_16k"
    PitcherBase = "019_pitcher_base_16k"
    BleachCleanser = "021_bleach_cleanser_16k"
    Bowl = "024_bowl_16k"
    Mug = "025_mug_16k"
    PowerDrill = "035_power_drill_16k"
    WoodBlock = "036_wood_block_16k"
    Scissors = "037_scissors_16k"
    LargeMarker = "040_large_marker_16k"
    LargeClamp = "051_large_clamp_16k"
    ExtraLargeClamp = "052_extra_large_clamp_16k"
    FoamBrick = "061_foam_brick_16k"


# Class ids: 1 + the object's position in ``FallingThingsObject``.
falling_things_object_ids = {
    member.value: index + 1
    for index, member in enumerate(FallingThingsObject)
}


@dataclass
class FallingThingsSample:
    intrinsics: np.ndarray          # [4] fx, fy, cx, cy
    valid: np.ndarray               # [N] bool
    classifications: np.ndarray     # [N] int
    bounding_boxes: np.ndarray      # [N, 4] normalized (y, x, h, w)
    camera_pose: np.ndarray         # [7] xyz (m) + quaternion xyzw
    poses: np.ndarray               # [N, 7]
    cuboids: np.ndarray             # [N, 8, 3]
    projected_cuboids: np.ndarray   # [N, 9, 2] (y, x) px, center prepended
    img: np.ndarray                 # [H, W, 3] uint8
    seg_map: np.ndarray             # [H, W] class ids
    depth_map: np.ndarray           # [H, W] meters


def quat_xyzw_to_rotm(q: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


class FallingThingsDataset:
    def __init__(
        self,
        root: str,
        variant: FallingThingsVariant,
        environments: List[FallingThingsEnvironment],
        objects: Optional[List[FallingThingsObject]] = None,
        transform=None,
    ):
        self._root = pathlib.Path(root).expanduser()
        self._variant = variant

        if variant != FallingThingsVariant.SINGLE and objects is not None:
            raise ValueError(
                "objects must be specified for variant SINGLE and cannot be "
                "specified for variant MIXED"
            )

        variant_dir = self._root / variant.value
        if not variant_dir.is_dir():
            raise ValueError(f"{variant_dir} does not exist")

        if variant == FallingThingsVariant.SINGLE:
            assert objects is not None
            object_dirs = [variant_dir / obj.value for obj in objects]
        else:
            object_dirs = [variant_dir]

        environment_dirs = [
            obj_dir / env.value
            for obj_dir in object_dirs
            for env in environments
        ]

        id_paths: List[pathlib.Path] = []
        for env_dir in environment_dirs:
            unique = set()
            for file in env_dir.iterdir():
                if file.is_file() and len(file.name) >= 6 and file.name[:6].isdigit():
                    unique.add(env_dir / file.name[:6])
            id_paths.extend(sorted(unique))
        self._id_paths = id_paths
        self._transform = transform

    def __len__(self) -> int:
        return len(self._id_paths)

    def __getitem__(self, i: int) -> FallingThingsSample:
        # An empty frame gives way to the next, iteratively.
        for attempt in range(len(self)):
            sample = self._load(self._id_paths[(i + attempt) % len(self)])
            if sample is not None:
                return sample
        raise RuntimeError("dataset contains no non-empty frames")

    def _load(self, id_path: pathlib.Path) -> Optional[FallingThingsSample]:
        camera_data = _read_json(id_path.with_name("_camera_settings.json"))
        object_data = _read_json(id_path.with_name("_object_settings.json"))
        left_data = _read_json(id_path.with_suffix(".left.json"))

        if len(left_data["objects"]) == 0:
            return None

        intr = camera_data["camera_settings"][0]["intrinsic_settings"]
        intrinsics = np.array(
            [intr["fx"], intr["fy"], intr["cx"], intr["cy"]], np.float32
        )

        classifications = np.array(
            [
                falling_things_object_ids[obj["class"].lower()]
                for obj in left_data["objects"]
            ],
            np.int64,
        )
        valid = classifications > 0

        with Image.open(id_path.with_suffix(".left.jpg")) as file:
            img = np.asarray(file.convert("RGB"))
        h, w = img.shape[:2]

        with Image.open(id_path.with_suffix(".left.seg.png")) as file:
            seg = np.asarray(file)
        if seg.ndim == 3:
            seg = seg[..., 0]
        seg = seg.astype(np.int32)
        for obj in object_data["exported_objects"]:
            seg = np.where(
                seg == obj["segmentation_class_id"],
                falling_things_object_ids[obj["class"].lower()],
                seg,
            )

        with Image.open(id_path.with_suffix(".left.depth.png")) as file:
            depth = np.asarray(file).astype(np.float32) / 1e4

        corners = np.array(
            [
                obj["bounding_box"]["top_left"]
                + obj["bounding_box"]["bottom_right"]
                for obj in left_data["objects"]
            ],
            np.float32,
        )  # rows: (y0, x0, y1, x1) in pixels
        corners[:, 0] /= h
        corners[:, 1] /= w
        corners[:, 2] /= h
        corners[:, 3] /= w
        bounding_boxes = np.stack(
            [
                (corners[:, 0] + corners[:, 2]) / 2,
                (corners[:, 1] + corners[:, 3]) / 2,
                corners[:, 2] - corners[:, 0],
                corners[:, 3] - corners[:, 1],
            ],
            axis=-1,
        )

        camera_pose = np.array(
            left_data["camera_data"]["location_worldframe"]
            + left_data["camera_data"]["quaternion_xyzw_worldframe"],
            np.float32,
        )
        camera_pose[:3] /= 100.0  # cm -> m

        poses = np.array(
            [
                obj["location"] + obj["quaternion_xyzw"]
                for obj in left_data["objects"]
            ],
            np.float32,
        )
        poses[:, :3] /= 100.0

        cuboids = np.array(
            [obj["cuboid"] for obj in left_data["objects"]], np.float32
        )

        # Projected cuboids come (x, y); flip them to (y, x) and put the 2D
        # box centre, in pixels, in front.
        projected = np.array(
            [obj["projected_cuboid"] for obj in left_data["objects"]],
            np.float32,
        )[..., ::-1]
        centers_px = bounding_boxes[:, 0:2] * np.array([h, w], np.float32)
        projected_cuboids = np.concatenate(
            (centers_px[:, None, :], projected), axis=1
        )

        sample = FallingThingsSample(
            intrinsics=intrinsics,
            valid=valid,
            classifications=classifications,
            bounding_boxes=bounding_boxes.astype(np.float32),
            camera_pose=camera_pose,
            poses=poses,
            cuboids=cuboids,
            projected_cuboids=projected_cuboids.astype(np.float32),
            img=img,
            seg_map=seg,
            depth_map=depth,
        )
        if self._transform is not None:
            sample = self._transform(sample)
        return sample


def _read_json(path: pathlib.Path) -> Dict:
    with open(path) as fp:
        return json.load(fp)
