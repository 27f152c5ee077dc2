"""Host-side augmentation pipeline with bbox/keypoint/mask label routing:
a copy of ``tauv_vision_tpu/data/augment.py`` on the same cv2 and numpy
(the card's machine has cv2), so that a transform drawn from the same
``np.random.Generator`` gives the same sample in both packages.

The reference drives albumentations Compose pipelines with
``bbox_params(label_fields=...)`` / ``keypoint_params`` routing
(yolact/scripts/train.py:413-455, centernet/scripts/train.py:144-177) plus
two custom transforms (utils/perlin.py Streaks, utils/overlay.py Overlay).
albumentations is not a dependency, so this module implements the same
capability on cv2/numpy with an explicit contract:

Sample dict fields:
- ``image``:  [H, W, 3] uint8
- ``mask``:   optional [H, W] int (nearest-resampled, padded with
              ``mask_fill`` — 254 marks invalid-after-warp regions, the
              value the YOLACT loss excludes)
- ``bboxes``: optional [N, 4] normalized corner boxes (xmin, ymin, xmax,
              ymax); per-box label arrays listed in ``bbox_fields`` are
              filtered in lockstep when boxes drop below min_visibility
- ``keypoints``: optional [K, 2] pixel (x, y); per-keypoint arrays in
              ``keypoint_fields`` are filtered in lockstep when keypoints
              leave the frame

Geometric transforms update boxes by transforming their corner points and
re-enclosing (albumentations' behavior for rotations).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import cv2
import numpy as np

MASK_INVALID = 254


@dataclasses.dataclass
class Sample:
    image: np.ndarray
    mask: Optional[np.ndarray] = None
    bboxes: Optional[np.ndarray] = None            # [N, 4] normalized corners
    bbox_fields: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    keypoints: Optional[np.ndarray] = None         # [K, 2] pixel (x, y)
    keypoint_fields: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def copy(self) -> "Sample":
        return Sample(
            image=self.image,
            mask=self.mask,
            bboxes=None if self.bboxes is None else self.bboxes.copy(),
            bbox_fields={k: v.copy() for k, v in self.bbox_fields.items()},
            keypoints=None if self.keypoints is None else self.keypoints.copy(),
            keypoint_fields={k: v.copy() for k, v in self.keypoint_fields.items()},
        )


class Transform:
    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        raise NotImplementedError


def _apply_matrix_to_sample(
    sample: Sample, matrix: np.ndarray, out_hw: Tuple[int, int],
    border_value: int = 0, perspective: bool = False,
) -> Sample:
    """Warp image/mask/boxes/keypoints by a 2x3 affine or 3x3 perspective
    matrix.  The mask is padded with MASK_INVALID so warped-in regions are
    excluded from losses (the reference sets mask_value=254,
    yolact/scripts/train.py:441-455)."""
    h, w = sample.image.shape[:2]
    oh, ow = out_hw

    if perspective:
        image = cv2.warpPerspective(
            sample.image, matrix, (ow, oh), flags=cv2.INTER_LINEAR,
            borderValue=(border_value,) * 3,
        )
    else:
        image = cv2.warpAffine(
            sample.image, matrix[:2], (ow, oh), flags=cv2.INTER_LINEAR,
            borderValue=(border_value,) * 3,
        )

    mask = sample.mask
    if mask is not None:
        warp = cv2.warpPerspective if perspective else cv2.warpAffine
        m = matrix if perspective else matrix[:2]
        mask = warp(
            mask.astype(np.float32), m, (ow, oh), flags=cv2.INTER_NEAREST,
            borderValue=MASK_INVALID,
        ).astype(mask.dtype)

    def transform_points(pts_px: np.ndarray) -> np.ndarray:
        if len(pts_px) == 0:
            return pts_px
        ones = np.ones((len(pts_px), 1))
        homo = np.concatenate([pts_px, ones], axis=1)  # [N, 3]
        out = homo @ matrix.T  # [N, 3] (affine matrix is 3x3 w/ [0,0,1])
        if perspective:
            out = out[:, :2] / out[:, 2:3]
        else:
            out = out[:, :2]
        return out

    bboxes = sample.bboxes
    if bboxes is not None and len(bboxes):
        scale = np.array([w, h, w, h], np.float32)
        corners_px = bboxes * scale
        pts = np.stack(
            [
                corners_px[:, [0, 1]], corners_px[:, [2, 1]],
                corners_px[:, [0, 3]], corners_px[:, [2, 3]],
            ],
            axis=1,
        ).reshape(-1, 2)
        warped = transform_points(pts).reshape(-1, 4, 2)
        xmin = warped[..., 0].min(1) / ow
        xmax = warped[..., 0].max(1) / ow
        ymin = warped[..., 1].min(1) / oh
        ymax = warped[..., 1].max(1) / oh
        bboxes = np.stack([xmin, ymin, xmax, ymax], axis=-1)

    keypoints = sample.keypoints
    if keypoints is not None and len(keypoints):
        keypoints = transform_points(keypoints.astype(np.float32))

    return Sample(
        image=image, mask=mask, bboxes=bboxes, bbox_fields=sample.bbox_fields,
        keypoints=keypoints, keypoint_fields=sample.keypoint_fields,
    )


class HorizontalFlip(Transform):
    def __init__(self, p: float):
        self.p = p

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        h, w = sample.image.shape[:2]
        m = np.asarray([[-1, 0, w - 1], [0, 1, 0], [0, 0, 1]], np.float32)
        return _apply_matrix_to_sample(sample, m, (h, w))


class VerticalFlip(Transform):
    def __init__(self, p: float):
        self.p = p

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        h, w = sample.image.shape[:2]
        m = np.asarray([[1, 0, 0], [0, -1, h - 1], [0, 0, 1]], np.float32)
        return _apply_matrix_to_sample(sample, m, (h, w))


class Resize(Transform):
    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def __call__(self, sample, rng):
        h, w = sample.image.shape[:2]
        m = np.asarray(
            [[self.width / w, 0, 0], [0, self.height / h, 0], [0, 0, 1]],
            np.float32,
        )
        return _apply_matrix_to_sample(sample, m, (self.height, self.width))


class ShiftScaleRotate(Transform):
    """albumentations-style SSR: shift (fraction), scale (1+limit),
    rotate (degrees), about the image center."""

    def __init__(self, p, shift_limit=(-0.0625, 0.0625),
                 scale_limit=(-0.1, 0.1), rotate_limit=(-45, 45)):
        self.p = p
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.rotate_limit = rotate_limit

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        h, w = sample.image.shape[:2]
        angle = rng.uniform(*self.rotate_limit)
        scale = 1.0 + rng.uniform(*self.scale_limit)
        dx = rng.uniform(*self.shift_limit) * w
        dy = rng.uniform(*self.shift_limit) * h
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
        m[0, 2] += dx
        m[1, 2] += dy
        m3 = np.concatenate([m, [[0, 0, 1]]], axis=0).astype(np.float32)
        return _apply_matrix_to_sample(sample, m3, (h, w))


class Perspective(Transform):
    """Random 4-corner jitter perspective warp."""

    def __init__(self, p, scale_limit=(0.05, 0.1)):
        self.p = p
        self.scale_limit = scale_limit

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        h, w = sample.image.shape[:2]
        scale = rng.uniform(*self.scale_limit)
        src = np.asarray([[0, 0], [w, 0], [0, h], [w, h]], np.float32)
        jitter = rng.uniform(-scale, scale, (4, 2)).astype(np.float32)
        dst = src + jitter * np.asarray([w, h], np.float32)
        m = cv2.getPerspectiveTransform(src, dst).astype(np.float32)
        return _apply_matrix_to_sample(sample, m, (h, w), perspective=True)


class ChannelShuffle(Transform):
    def __init__(self, p):
        self.p = p

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        out = sample.copy()
        out.image = sample.image[..., rng.permutation(3)]
        return out


class ColorJitter(Transform):
    def __init__(self, p, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.05):
        self.p = p
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        img = sample.image.astype(np.float32) / 255.0

        img = img * (1.0 + rng.uniform(-self.brightness, self.brightness))
        mean = img.mean()
        img = (img - mean) * (1.0 + rng.uniform(-self.contrast, self.contrast)) + mean

        gray = img.mean(axis=-1, keepdims=True)
        img = gray + (img - gray) * (1.0 + rng.uniform(-self.saturation, self.saturation))

        hsv = cv2.cvtColor(
            (np.clip(img, 0, 1) * 255).astype(np.uint8), cv2.COLOR_RGB2HSV
        ).astype(np.float32)
        hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue, self.hue) * 180) % 180
        img = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)

        out = sample.copy()
        out.image = img
        return out


class GaussNoise(Transform):
    def __init__(self, p, var_limit=(10.0, 50.0)):
        self.p = p
        self.var_limit = var_limit

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        var = rng.uniform(*self.var_limit)
        noise = rng.normal(0, var**0.5, sample.image.shape)
        out = sample.copy()
        out.image = np.clip(
            sample.image.astype(np.float32) + noise, 0, 255
        ).astype(np.uint8)
        return out


class Blur(Transform):
    def __init__(self, p, blur_limit=(3, 7)):
        self.p = p
        self.blur_limit = blur_limit

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        k = int(rng.integers(self.blur_limit[0] // 2, self.blur_limit[1] // 2 + 1)) * 2 + 1
        out = sample.copy()
        out.image = cv2.blur(sample.image, (k, k))
        return out


def fractal_perlin(rng: np.random.Generator, shape: Tuple[int, int],
                   octaves: int = 4) -> np.ndarray:
    """Fractal value noise in [0, 1] (utils/perlin.py capability)."""
    h, w = shape
    out = np.zeros((h, w), np.float32)
    amplitude = 1.0
    total = 0.0
    for octave in range(octaves):
        step = 2 ** (octaves - octave + 1)
        gh, gw = max(h // step, 2), max(w // step, 2)
        grid = rng.uniform(0, 1, (gh, gw)).astype(np.float32)
        layer = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC)
        out += amplitude * layer
        total += amplitude
        amplitude *= 0.5
    out /= total
    return np.clip(out, 0, 1)


class Streaks(Transform):
    """Perlin-noise light streaks blended over the image
    (utils/perlin.py:71-89): a rotated, stretched noise band modulates
    brightness."""

    def __init__(self, p, intensity=(0.2, 0.6), n_maps: int = 8,
                 map_hw: Tuple[int, int] = (128, 128)):
        self.p = p
        self.intensity = intensity
        self._maps: Optional[List[np.ndarray]] = None
        self.n_maps = n_maps
        self.map_hw = map_hw

    def _bank(self, rng):
        if self._maps is None:
            self._maps = [
                fractal_perlin(rng, self.map_hw) for _ in range(self.n_maps)
            ]
        return self._maps

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p:
            return sample
        h, w = sample.image.shape[:2]
        noise = self._bank(rng)[int(rng.integers(self.n_maps))]
        stretched = cv2.resize(noise, (w * 2, h * 2))
        angle = rng.uniform(-30, 30)
        m = cv2.getRotationMatrix2D((w, h), angle, 1.0)
        rotated = cv2.warpAffine(stretched, m, (w * 2, h * 2))
        crop = rotated[h // 2: h // 2 + h, w // 2: w // 2 + w]
        gain = 1.0 + rng.uniform(*self.intensity) * (crop[..., None] - 0.5) * 2
        out = sample.copy()
        out.image = np.clip(
            sample.image.astype(np.float32) * gain, 0, 255
        ).astype(np.uint8)
        return out


class Overlay(Transform):
    """Random rotated/scaled image overlays — caustics etc.
    (utils/overlay.py:25-46)."""

    def __init__(self, p, overlays: Sequence[np.ndarray], alpha=(0.2, 0.5)):
        self.p = p
        self.overlays = list(overlays)
        self.alpha = alpha

    def __call__(self, sample, rng):
        if rng.uniform() >= self.p or not self.overlays:
            return sample
        h, w = sample.image.shape[:2]
        overlay = self.overlays[int(rng.integers(len(self.overlays)))]
        scale = rng.uniform(0.8, 1.5)
        angle = rng.uniform(0, 360)
        m = cv2.getRotationMatrix2D(
            (overlay.shape[1] / 2, overlay.shape[0] / 2), angle, scale
        )
        warped = cv2.warpAffine(overlay, m, (w, h))
        if warped.ndim == 2:
            warped = warped[..., None].repeat(3, -1)
        alpha = rng.uniform(*self.alpha)
        out = sample.copy()
        out.image = np.clip(
            sample.image.astype(np.float32) * (1 - alpha)
            + warped.astype(np.float32) * alpha,
            0, 255,
        ).astype(np.uint8)
        return out


class Compose(Transform):
    """Apply transforms in order, then clip boxes, filter boxes by
    visibility, and cull off-frame keypoints with field routing
    (albumentations BboxParams(min_visibility=...) semantics)."""

    def __init__(self, transforms: Sequence[Transform], min_visibility: float = 0.0):
        self.transforms = list(transforms)
        self.min_visibility = min_visibility

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        original_areas = None
        if sample.bboxes is not None and len(sample.bboxes):
            b = sample.bboxes
            original_areas = np.maximum(
                (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), 1e-9
            )

        out = sample.copy()
        for transform in self.transforms:
            out = transform(out, rng)

        if out.bboxes is not None and len(out.bboxes):
            clipped = np.clip(out.bboxes, 0.0, 1.0)
            areas = np.maximum(
                (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1]),
                0.0,
            )
            visibility = areas / original_areas
            keep = (visibility >= self.min_visibility) & (areas > 0)
            out.bboxes = clipped[keep]
            out.bbox_fields = {k: v[keep] for k, v in out.bbox_fields.items()}

        if out.keypoints is not None and len(out.keypoints):
            h, w = out.image.shape[:2]
            k = out.keypoints
            keep = (
                (k[:, 0] >= 0) & (k[:, 0] < w) & (k[:, 1] >= 0) & (k[:, 1] < h)
            )
            out.keypoints = k[keep]
            out.keypoint_fields = {
                key: v[keep] for key, v in out.keypoint_fields.items()
            }

        return out
