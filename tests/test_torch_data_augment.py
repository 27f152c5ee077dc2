"""The port's augmentation transforms against the JAX package's.

Each transform is applied by both packages to the same sample (a frame
with a segmentation mask, boxes with label fields, keypoints with
theirs) from generators of the same seed, with p = 1 (the transform
always applies) and p = 0.5 (the draw that decides it comes first, as in
JAX's order).  The port draws in JAX's order on the same cv2 and numpy,
so everything is held equal: the image and mask exactly, boxes and
keypoints exactly, and the label fields that ``Compose`` filters
(``min_visibility``, keypoints leaving the frame) exactly.
"""

import numpy as np
import pytest

from tauv_vision_tpu.data import augment as jax_augment
from tauv_vision_tpu_torch.data import augment

H, W = 60, 96
SEEDS = range(4)


def _sample(module, rng):
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    mask = rng.integers(0, 5, (H, W)).astype(np.uint8)
    xy = rng.uniform(0.0, 0.7, (5, 2))
    wh = rng.uniform(0.05, 0.3, (5, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    keypoints = (rng.uniform(0, 1, (7, 2)) * [W, H]).astype(np.float32)
    return module.Sample(
        image=img, mask=mask, bboxes=boxes,
        bbox_fields={"labels": np.arange(5), "yaw": rng.uniform(-1, 1, 5).astype(np.float32)},
        keypoints=keypoints,
        keypoint_fields={"labels": np.arange(7), "object_indices": np.arange(7) % 5})


def _transforms(module, p):
    overlay = np.random.default_rng(3).integers(0, 256, (40, 50, 3), np.uint8)
    return {
        "ColorJitter": module.ColorJitter(p=p),
        "GaussNoise": module.GaussNoise(p=p),
        "Blur": module.Blur(p=p),
        "HorizontalFlip": module.HorizontalFlip(p=p),
        "VerticalFlip": module.VerticalFlip(p=p),
        "ShiftScaleRotate": module.ShiftScaleRotate(p=p),
        "Resize": module.Resize(36, 64),
        "Perspective": module.Perspective(p=p),
        "ChannelShuffle": module.ChannelShuffle(p=p),
        "Streaks": module.Streaks(p=p, map_hw=(32, 32), n_maps=2),
        "Overlay": module.Overlay(p=p, overlays=[overlay]),
        "train_pipeline": module.Compose([
            module.ColorJitter(p=0.8), module.GaussNoise(p=0.4), module.Blur(p=0.3),
            module.HorizontalFlip(p=0.5), module.ShiftScaleRotate(p=0.5),
            module.Resize(36, 64)], min_visibility=0.2),
    }


def _assert_same_sample(got, want, what):
    for name in ("image", "mask", "bboxes", "keypoints"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), (what, name)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
    for fields in ("bbox_fields", "keypoint_fields"):
        g, w = getattr(got, fields), getattr(want, fields)
        assert set(g) == set(w), (what, fields)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{what} {fields}.{k}")


@pytest.mark.parametrize("p", [1.0, 0.5])
@pytest.mark.parametrize("name", list(_transforms(augment, 1.0)))
def test_torch_augment_transform_matches_jax(name, p):
    port, jax = _transforms(augment, p)[name], _transforms(jax_augment, p)[name]
    for seed in SEEDS:
        src = np.random.default_rng(100 + seed)
        sample = _sample(augment, src)
        jax_sample = jax_augment.Sample(**vars(sample))
        got = port(sample, np.random.default_rng(seed))
        want = jax(jax_sample, np.random.default_rng(seed))
        _assert_same_sample(got, want, f"{name} seed {seed}")


@pytest.mark.parametrize("min_visibility", [0.0, 0.2, 0.9])
def test_torch_compose_filters_labels_as_jax(min_visibility):
    """Boxes shifted half out of the frame: ``min_visibility`` drops some,
    and their label fields with them; keypoints that leave the frame drop
    with theirs."""
    kept = []
    for seed in SEEDS:
        sample = _sample(augment, np.random.default_rng(200 + seed))
        steps = [augment.ShiftScaleRotate(p=1.0, shift_limit=(0.3, 0.4))]
        jax_steps = [jax_augment.ShiftScaleRotate(p=1.0, shift_limit=(0.3, 0.4))]
        got = augment.Compose(steps, min_visibility)(sample, np.random.default_rng(seed))
        want = jax_augment.Compose(jax_steps, min_visibility)(
            jax_augment.Sample(**vars(sample)), np.random.default_rng(seed))
        _assert_same_sample(got, want, f"seed {seed}")
        kept.append((len(got.bboxes), len(got.keypoints)))
    assert any(b < 5 for b, _ in kept) and any(k < 7 for _, k in kept)
