"""CenterNet configuration: the part of ``tauv_vision_tpu/configs/centernet.py``
that the port uses, copied so the port imports nothing of the JAX package.

Frozen dataclasses with the same fields, defaults and derived properties;
``ObjectConfig`` flags derive the network's head structure through
``get_head_channels``.  The JSON round trip and the keypoint-index codec
of the original are not copied: the port does not use them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
    """The per-class configs; the ``train_*`` properties OR over all
    classes and decide which prediction heads the network has."""

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
