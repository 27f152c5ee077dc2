"""The port's YOLACT data path against the JAX package's.

- ``generate_square_seg_batch``: bit-equal to JAX's on generators of the
  same seed (every array, dtypes included).
- ``SegmentationDataset`` (``load_segmentation_sample``) and
  ``collate_segmentation_samples``: bit-equal to JAX's on one directory of
  ``write_square_seg_dataset``'s squares (the CLI's 7 classes, 64x96
  PNGs with their ``_seg.png`` maps) and three samples written by the
  test (a 254, warp-invalid, region; squares at the lower right corner),
  with generators of the same seed, under no transform, the CLI's val
  and train transforms, and a shift that moves the corner squares out of
  the frame: their boxes drop below ``min_visibility``, so a sample's seg
  map is remapped to its surviving slots, and a sample whose boxes all
  drop takes the empty-image fallback.
- ``BatchLoader`` over a ``ConcatDataset`` of two such directories, one
  worker, the same seed: the same batches in the same order as JAX's.
"""

import dataclasses
import pathlib

import numpy as np
import pytest

from tauv_vision_tpu.data import augment as jax_augment
from tauv_vision_tpu.data import dataset_dir as jax_dataset_dir
from tauv_vision_tpu.data import loader as jax_loader
from tauv_vision_tpu.data import segmentation_dataset as jax_seg
from tauv_vision_tpu.data.synthetic import SquareDatasetConfig as JaxSquareConfig
from tauv_vision_tpu.data.synthetic import generate_square_seg_batch as jax_generate
from tauv_vision_tpu.scripts import train_yolact as jax_cli
from tauv_vision_tpu_torch.data import augment, dataset_dir, loader
from tauv_vision_tpu_torch.data import segmentation_dataset as seg
from tauv_vision_tpu_torch.data.synthetic import (
    SquareDatasetConfig,
    generate_square_seg_batch,
    square_seg_samples,
    write_square_seg_dataset,
)
from tauv_vision_tpu_torch.scripts import train_yolact as port_cli
from torch_parity import jax_yolact_config, jax_yolact_train_config

H, W = 64, 96
LABELS = [c.id for c in port_cli.class_config.configs]
CLASS_MAP = {c.id: c.index for c in port_cli.class_config.configs}
MC = dataclasses.replace(port_cli.model_config, in_h=48, in_w=80)


@pytest.mark.parametrize("seed,config", [
    (0, dict(in_h=64, in_w=96, max_objects=4, min_side=10, max_side=24)),
    (5, dict(in_h=64, in_w=64, max_objects=2)),
    (9, dict(in_h=90, in_w=160, max_objects=16, min_side=6, max_side=30)),
])
def test_torch_generate_square_seg_batch_matches_jax(seed, config):
    img, fields = generate_square_seg_batch(np.random.default_rng(seed), 3,
                                            SquareDatasetConfig(**config))
    want_img, want = jax_generate(np.random.default_rng(seed), 3, JaxSquareConfig(**config))
    assert img.dtype == want_img.dtype and np.array_equal(img, want_img)
    assert fields.keys() == want.keys()
    for k in fields:
        assert fields[k].dtype == want[k].dtype and np.array_equal(fields[k], want[k]), k
    assert fields["valid"].sum() >= 3


def _invalid_sample():
    """A sample whose lower right corner is warp-invalid (254), one square
    in it and one out."""
    s = square_seg_samples(np.random.default_rng(7), 1, H, W, LABELS, max_objects=2)[0]
    s.seg[H // 2:, W // 2:] = 254
    return dataclasses.replace(s, id="invalid")


def _corner_sample(id, squares):
    """12-pixel squares at the given (top, left) corners, in slot order."""
    img = np.full((H, W, 3), 40, np.uint8)
    segmap = np.full((H, W), 255, np.uint8)
    objects = []
    for i, (y, x) in enumerate(squares):
        segmap[y:y + 12, x:x + 12] = i
        img[y:y + 12, x:x + 12] = 220
        objects.append({"class_id": LABELS[2], "bbox": {
            "x": (x + 6) / W, "y": (y + 6) / H, "w": 12 / W, "h": 12 / H}})
    return dataset_dir.DatasetSample(id=id, img=img, seg=segmap, objects=objects)


# The shift moves a square at the lower right corner out of the frame:
# "corner" loses its only box (the empty-image fallback), "pair" its first
# (its second box moves to slot 0, and the seg map with it).
EXTRA = {"corner": ((46, 78),), "pair": ((46, 78), (4, 4))}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("seg")
    out = []
    for i in range(2):
        root = base / f"d{i}"
        write_square_seg_dataset(root, np.random.default_rng(10 + i), 6, 2, H, W, LABELS)
        dataset_dir.write_sample(root / "data", _invalid_sample())
        for id, squares in EXTRA.items():
            dataset_dir.write_sample(root / "data", _corner_sample(id, squares))
        splits = dataset_dir.read_ids(root, dataset_dir.Split.TRAIN)
        dataset_dir.write_splits(root, {"train": splits + ["invalid", *EXTRA],
                                        "val": dataset_dir.read_ids(root, dataset_dir.Split.VAL),
                                        "test": []})
        out.append(root)
    return out


def _shift(module):
    """Every box moves right and down by 45% of the frame: the ones on the
    far side fall below the CLI's visibility of 0.3."""
    return module.Compose([module.ShiftScaleRotate(p=1.0, shift_limit=(0.45, 0.45),
                                                   scale_limit=(0.0, 0.0),
                                                   rotate_limit=(0.0, 0.0)),
                           module.Resize(MC.in_h, MC.in_w)], min_visibility=0.3)


TRANSFORMS = {
    "none": lambda cli, aug, mc, tc: None,
    "val": lambda cli, aug, mc, tc: aug.Compose([aug.Resize(mc.in_h, mc.in_w)]),
    "train": lambda cli, aug, mc, tc: cli.build_train_transform(mc, tc),
    "shift": lambda cli, aug, mc, tc: _shift(aug),
}


def _datasets(root, split, transform):
    make = TRANSFORMS[transform]
    port = seg.SegmentationDataset(root, getattr(dataset_dir.Split, split), CLASS_MAP,
                                   make(port_cli, augment, MC, port_cli.train_config))
    jax = jax_seg.SegmentationDataset(
        root, getattr(jax_dataset_dir.Split, split), CLASS_MAP,
        make(jax_cli, jax_augment, jax_yolact_config(MC),
             jax_yolact_train_config(port_cli.train_config)))
    return port, jax


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("transform", list(TRANSFORMS))
def test_torch_segmentation_dataset_matches_jax(roots, transform):
    port, jax = _datasets(roots[0], "TRAIN", transform)
    assert port.ids == jax.ids and len(port) == 9
    samples = []
    for _ in range(3):   # the dataset's generator moves on between draws
        for i in range(len(port)):
            got, want = port[i], jax[i]
            _assert_same(got, want, f"{transform} {port.ids[i]}")
            samples.append((got, want))
    if transform == "shift":
        corner, pair = port[port.ids.index("corner")], port[port.ids.index("pair")]
        assert not corner["valid"].any() and len(corner["valid"]) == 1
        assert pair["valid"].tolist() == [True]
        assert (pair["seg"] == 0).any() and not (pair["seg"] == 1).any()
    invalid = port[port.ids.index("invalid")]
    if transform in ("none", "val"):
        assert not invalid["img_valid"].all() and invalid["img_valid"].any()
    got = seg.collate_segmentation_samples([s for s, _ in samples[:5]], 16)
    want = jax_seg.collate_segmentation_samples([s for _, s in samples[:5]], 16)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    for f in dataclasses.fields(got[1]):
        g, w = getattr(got[1], f.name), np.asarray(getattr(want[1], f.name))
        assert g.dtype == w.dtype and np.array_equal(g, w), f.name


def test_torch_segmentation_loader_matches_jax(roots):
    batch = 3

    def make(module, ds_module, Split, concat):
        datasets = [ds_module.SegmentationDataset(
            r, Split.TRAIN, CLASS_MAP,
            TRANSFORMS["val"](None, augment if module is loader else jax_augment, MC, None))
            for r in roots]
        return module.BatchLoader(concat(datasets), batch,
                                  lambda s: ds_module.collate_segmentation_samples(s, 16),
                                  n_workers=1, seed=3)

    port = make(loader, seg, dataset_dir.Split, loader.ConcatDataset)
    jax = make(jax_loader, jax_seg, jax_dataset_dir.Split, jax_loader.ConcatDataset)
    assert len(port) == len(jax) == 18 // batch
    for _ in range(2):
        pairs = list(zip(port, jax))
        assert len(pairs) == len(port)
        for (img, truth), (want_img, want) in pairs:
            np.testing.assert_array_equal(img, want_img)
            for f in dataclasses.fields(truth):
                np.testing.assert_array_equal(getattr(truth, f.name), getattr(want, f.name))


def test_torch_seg_dataset_writer_reads_back(roots):
    """What ``write_square_seg_dataset`` writes is the directory contract:
    every object's pixels carry its index in the seg map, inside its box."""
    root = pathlib.Path(roots[1])
    assert dataset_dir.read_classes(root) == LABELS
    for id in dataset_dir.read_ids(root, dataset_dir.Split.VAL):
        s = dataset_dir.read_sample(root / "data", id, load_seg=True)
        assert s.img.shape == (H, W, 3) and s.seg.shape == (H, W)
        for i, obj in enumerate(s.objects):
            ys, xs = np.nonzero(s.seg == i)
            bb = obj["bbox"]
            assert len(ys) and obj["class_id"] in LABELS
            assert abs((ys.min() + ys.max()) / 2 / H - bb["y"]) < 1.5 / H
            assert abs((xs.min() + xs.max()) / 2 / W - bb["x"]) < 1.5 / W
