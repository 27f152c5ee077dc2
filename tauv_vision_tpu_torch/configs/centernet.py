"""CenterNet configuration: the part of ``tauv_vision_tpu/configs/centernet.py``
that the port uses, copied so the port imports nothing of the JAX package.

Frozen dataclasses with the same fields, defaults and derived properties
(the training hyperparameters included, ``CenternetTrainConfig``);
``ObjectConfig`` flags derive the network's head structure through
``get_head_channels``, and ``ObjectConfigSet`` carries the keypoint-index
codec that the keypoint decode's matcher reads.  The JSON round trip of
the original is not copied: the port does not use it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class CenternetModelConfig:
    """Architecture and geometry knobs."""

    in_h: int
    in_w: int

    backbone_heights: Tuple[int, ...]
    backbone_channels: Tuple[int, ...]

    downsamples: int

    angle_bin_overlap: float

    def __post_init__(self):
        object.__setattr__(self, "backbone_heights", tuple(self.backbone_heights))
        object.__setattr__(self, "backbone_channels", tuple(self.backbone_channels))

    @property
    def downsample_ratio(self) -> int:
        return 2 ** self.downsamples

    @property
    def out_h(self) -> int:
        return self.in_h // self.downsample_ratio

    @property
    def out_w(self) -> int:
        return self.in_w // self.downsample_ratio


@dataclass(frozen=True)
class CenternetTrainConfig:
    """Training hyperparameters."""

    lr: float

    batch_size: int
    n_batches: int
    n_epochs: int

    heatmap_focal_loss_a: float
    heatmap_focal_loss_b: float
    heatmap_sigma_factor: float

    keypoint_heatmap_sigma: float
    keypoint_affinity_sigma: float

    loss_lambda_keypoint_heatmap: float
    loss_lambda_keypoint_affinity: float
    loss_lambda_size: float
    loss_lambda_offset: float
    loss_lambda_angle: float
    loss_lambda_depth: float

    n_workers: int = 0
    weight_save_interval: int = 10
    grad_max_norm: float = 1.0

    # Penalise DCN offsets beyond dcn_offset_range (0 disables), so that
    # kernels with a bounded sampling window stay exact.
    loss_lambda_dcn_offset: float = 0.0
    dcn_offset_range: float = 1.0

    # Padded objects and keypoints a sample, so every batch has one shape,
    # and the compute dtype.
    max_objects: int = 16
    max_keypoints: int = 64
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class AngleConfig:
    """Per-angle training flag and modulo."""

    train: bool
    modulo: Optional[float]


@dataclass(frozen=True)
class ObjectConfig:
    """Per-class head configuration."""

    id: str

    yaw: AngleConfig
    pitch: AngleConfig
    roll: AngleConfig

    train_depth: bool
    train_keypoints: bool

    keypoints: Optional[Tuple[Tuple[float, float, float], ...]] = None

    def __post_init__(self):
        if self.keypoints is not None:
            object.__setattr__(
                self, "keypoints", tuple(tuple(kp) for kp in self.keypoints)
            )


@dataclass(frozen=True)
class ObjectConfigSet:
    """The per-class configs and the global keypoint-index codec; the
    ``train_*`` properties OR over all classes and decide which
    prediction heads the network has, and the keypoint channels are the
    concatenation of every class's local keypoint list."""

    configs: Tuple[ObjectConfig, ...]

    def __post_init__(self):
        object.__setattr__(self, "configs", tuple(self.configs))

    @property
    def train_yaw(self) -> bool:
        return any(c.yaw.train for c in self.configs)

    @property
    def train_pitch(self) -> bool:
        return any(c.pitch.train for c in self.configs)

    @property
    def train_roll(self) -> bool:
        return any(c.roll.train for c in self.configs)

    @property
    def train_depth(self) -> bool:
        return any(c.train_depth for c in self.configs)

    @property
    def train_keypoints(self) -> bool:
        return any(c.train_keypoints for c in self.configs)

    @property
    def n_labels(self) -> int:
        return len(self.configs)

    @property
    def n_keypoints(self) -> int:
        return sum(
            len(c.keypoints) if c.keypoints is not None else 0 for c in self.configs
        )

    @property
    def label_id_to_index(self) -> Dict[str, int]:
        return {c.id: i for i, c in enumerate(self.configs)}

    def _keypoint_tables(self):
        """({(object, local keypoint): flat channel}, its inverse)."""
        encode: Dict[Tuple[int, int], int] = {}
        decode: Dict[int, Tuple[int, int]] = {}
        flat = 0
        for obj_i, c in enumerate(self.configs):
            if c.keypoints is None:
                continue
            for local_i in range(len(c.keypoints)):
                encode[(obj_i, local_i)] = flat
                decode[flat] = (obj_i, local_i)
                flat += 1
        return encode, decode

    def encode_keypoint_index(self, object_index: int, object_keypoint_index: int) -> int:
        return self._keypoint_tables()[0][(object_index, object_keypoint_index)]

    def decode_keypoint_index(self, keypoint_index: int) -> Tuple[int, int]:
        return self._keypoint_tables()[1][keypoint_index]

    def keypoint_owner_labels(self) -> Tuple[int, ...]:
        """Owning object label for each flat keypoint channel."""
        _, decode = self._keypoint_tables()
        return tuple(decode[i][0] for i in range(self.n_keypoints))

    def get_by_label(self, label: str) -> ObjectConfig:
        return self.configs[self.label_id_to_index[label]]


def get_head_channels(object_config: ObjectConfigSet) -> Tuple[int, ...]:
    """Per-head channel counts in the fixed order the model emits them:

    heatmap, [kp heatmap, kp affinity], size, offset,
    [yaw bin, yaw offset], [pitch bin, pitch offset],
    [roll bin, roll offset], [depth].
    """
    channels = [object_config.n_labels]
    if object_config.train_keypoints:
        channels.extend((object_config.n_keypoints, 2 * object_config.n_keypoints))
    channels.extend((2, 2))
    if object_config.train_yaw:
        channels.extend((4, 4))
    if object_config.train_pitch:
        channels.extend((4, 4))
    if object_config.train_roll:
        channels.extend((4, 4))
    if object_config.train_depth:
        channels.append(1)
    return tuple(channels)
