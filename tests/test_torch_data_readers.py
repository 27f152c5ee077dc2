"""The port's on-disk readers against the JAX package's.

Dataset directories are built in ``tmp_path`` from the synthetic squares
(``data/synthetic.square_pose_samples``: uint8 frames, the four classes
of ``configs/samples_torpedo.py``, poses whose ``cam_t_object`` projects
each object's keypoint onto its square), written once by the JAX
package's writer and once by the port's, and also as
``tests/test_eval_data.py`` builds one.  On the same files:

- ``read_image``: bit-equal to JAX's, on PNGs written by JAX's
  ``write_png`` and by PIL (RGB, RGBA, grayscale, palette; channels 1, 3,
  4 and None); a 16-bit PNG raises, and so does RGBA read as RGB, where
  JAX's libpng codec composites the alpha over black and its PIL
  fallback drops it;
- ``read_sample``, ``load_pose_sample`` with the CLI's train and val
  transforms on generators of the same seed, and ``collate_pose_samples``:
  every array equal (images exact, boxes, keypoints and filtered labels
  exact);
- ``BatchLoader`` over a ``ConcatDataset`` of two directories, one
  worker, the same seed: the same batches in the same order, epoch after
  epoch, with ``drop_last``.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
from PIL import Image

from tauv_vision_tpu.data import dataset_dir as jax_dataset_dir
from tauv_vision_tpu.data import image_io as jax_image_io
from tauv_vision_tpu.data import loader as jax_loader
from tauv_vision_tpu.data import pose_dataset as jax_pose_dataset
from tauv_vision_tpu.scripts import train_centernet as jax_cli
from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data import dataset_dir, image_io, loader, pose_dataset
from tauv_vision_tpu_torch.data.synthetic import square_pose_samples, write_square_pose_dataset
from tauv_vision_tpu_torch.scripts import train_centernet as port_cli
from torch_parity import jax_centernet_config, jax_object_config, jax_train_config
from test_eval_data import _make_pose_dataset

H, W = 48, 80
OC = samples_torpedo.object_config
LABELS = [c.id for c in OC.configs]


def _write_jax(root: pathlib.Path, samples, n_train):
    for s in samples:
        jax_dataset_dir.write_sample(root / "data", jax_dataset_dir.DatasetSample(
            id=s.id, img=s.img, seg=s.seg, objects=s.objects, camera=s.camera))
    ids = [s.id for s in samples]
    jax_dataset_dir.write_splits(root, {"train": ids[:n_train], "val": ids[n_train:],
                                        "test": []})
    jax_dataset_dir.write_classes(root, LABELS)
    jax_dataset_dir.write_meta(root, "test", "synthetic squares", "2026-01-01T00:00:00")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Two directories of the same squares, one written by each package."""
    base = tmp_path_factory.mktemp("datasets")
    samples = square_pose_samples(np.random.default_rng(0), 6, H, W, LABELS)
    _write_jax(base / "jax", samples, 4)
    write_square_pose_dataset(base / "port", np.random.default_rng(0), 4, 2, H, W, LABELS)
    return {"jax": base / "jax", "port": base / "port"}


def _assert_same(got, want, what=""):
    if dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    elif isinstance(got, dict):
        assert set(got) == set(want), what
        for k in got:
            _assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(got, np.ndarray) or isinstance(want, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _images(rng):
    return {"RGB": rng.integers(0, 256, (H, W, 3), np.uint8),
            "RGBA": rng.integers(0, 256, (H, W, 4), np.uint8),
            "L": rng.integers(0, 256, (H, W), np.uint8)}


@pytest.mark.parametrize("writer", ["jax", "pil"])
@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_torch_read_image_matches_jax(tmp_path, writer, channels):
    rng = np.random.default_rng(1)
    paths = []
    for mode, img in _images(rng).items():
        path = tmp_path / f"{mode}.png"
        if writer == "jax":
            jax_image_io.write_png(path, img)
        else:
            Image.fromarray(img).save(path)
        paths.append(path)
    palette = Image.fromarray(rng.integers(0, 7, (H, W), np.uint8), mode="P")
    palette.putpalette(list(rng.integers(0, 256, 768)))
    palette.save(tmp_path / "P.png")
    paths.append(tmp_path / "P.png")
    for path in paths:
        if channels == 3 and path.stem == "RGBA":
            with pytest.raises(ValueError, match="alpha"):
                image_io.read_image(path, channels)
            continue
        got = image_io.read_image(path, channels)
        want = jax_image_io.read_image(path, channels)
        assert got.dtype == np.uint8, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_torch_write_png_round_trip_and_16_bit_raises(tmp_path):
    for mode, img in _images(np.random.default_rng(2)).items():
        image_io.write_png(tmp_path / f"{mode}.png", img)
        np.testing.assert_array_equal(jax_image_io.read_image(tmp_path / f"{mode}.png", None), img)
    Image.fromarray(np.arange(H * W, dtype=np.uint16).reshape(H, W)).save(tmp_path / "16.png")
    with pytest.raises(ValueError, match="mode"):
        image_io.read_image(tmp_path / "16.png", 1)
    with pytest.raises(ValueError):
        image_io.write_png(tmp_path / "f.png", np.zeros((H, W), np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_read_sample_matches_jax(roots, writer):
    root = roots[writer]
    for split in ("TRAIN", "VAL"):
        ids = dataset_dir.read_ids(root, getattr(dataset_dir.Split, split))
        assert ids == jax_dataset_dir.read_ids(root, getattr(jax_dataset_dir.Split, split))
        for id in ids:
            got = dataset_dir.read_sample(root / "data", id)
            want = jax_dataset_dir.read_sample(root / "data", id)
            _assert_same(dataclasses.asdict(got), dataclasses.asdict(want), id)
    assert dataset_dir.read_classes(root) == LABELS
    assert dataset_dir.dirhash(root / "data") == jax_dataset_dir.dirhash(root / "data")


def test_torch_eval_data_dataset_reads_as_jax(tmp_path):
    """``tests/test_eval_data.py``'s directory (a seg map, a keypoint that
    leaves the frame), through the port's reader with segmentation."""
    ids = _make_pose_dataset(tmp_path)
    for id in ids:
        got = dataset_dir.read_sample(tmp_path / "data", id, load_seg=True)
        want = jax_dataset_dir.read_sample(tmp_path / "data", id, load_seg=True)
        _assert_same(dataclasses.asdict(got), dataclasses.asdict(want), id)


def _pose_datasets(root, split, transform_of):
    mc, tc = samples_torpedo.model_config, samples_torpedo.train_config
    mc = dataclasses.replace(mc, in_h=32, in_w=64)
    port = pose_dataset.PoseDataset(root, getattr(dataset_dir.Split, split),
                                    OC.label_id_to_index, OC, transform_of(port_cli, mc, tc))
    joc = jax_object_config(OC)
    jax = jax_pose_dataset.PoseDataset(
        root, getattr(jax_dataset_dir.Split, split), joc.label_id_to_index, joc,
        transform_of(jax_cli, jax_centernet_config(mc), jax_train_config(tc)))
    return port, jax


TRANSFORMS = {
    "train": lambda cli, mc, tc: cli.build_train_transform(mc, tc),
    "val": lambda cli, mc, tc: cli.build_val_transform(mc),
    "none": lambda cli, mc, tc: None,
}


@pytest.mark.parametrize("transform", list(TRANSFORMS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torch_pose_dataset_matches_jax(roots, writer, transform):
    port, jax = _pose_datasets(roots[writer], "TRAIN", TRANSFORMS[transform])
    assert port.ids == jax.ids and len(port) == 4
    samples = []
    for _ in range(3):   # the dataset's generator moves on: three draws a sample
        for i in range(len(port)):
            got, want = port[i], jax[i]
            _assert_same(got, want, f"{transform} {i}")
            samples.append((got, want))
    got = pose_dataset.collate_pose_samples([s for s, _ in samples[:4]], 16, 64)
    want = jax_pose_dataset.collate_pose_samples([s for _, s in samples[:4]], 16, 64)
    _assert_same(got[0], want[0], "img")
    _assert_same(dataclasses.asdict(got[1]), {f.name: getattr(want[1], f.name)
                                              for f in dataclasses.fields(want[1])}, "truth")
    assert got[1].keypoint_valid.sum() > 0


def test_torch_batch_loader_matches_jax(roots):
    port_sets = [_pose_datasets(roots[w], "TRAIN", TRANSFORMS["train"]) for w in ("jax", "port")]
    batch = 3

    def collate(module):
        return lambda samples: module.collate_pose_samples(samples, 16, 64)

    port = loader.BatchLoader(loader.ConcatDataset([p for p, _ in port_sets]), batch,
                              collate(pose_dataset), n_workers=1, seed=5)
    jax = jax_loader.BatchLoader(jax_loader.ConcatDataset([j for _, j in port_sets]), batch,
                                 collate(jax_pose_dataset), n_workers=1, seed=5)
    assert len(port) == len(jax) == 8 // batch
    for _ in range(2):
        got, want = list(port), list(jax)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _assert_same(g[0], w[0], "img")
            _assert_same(dataclasses.asdict(g[1]), {f.name: getattr(w[1], f.name)
                                                    for f in dataclasses.fields(w[1])}, "truth")
    unshuffled = loader.BatchLoader(port_sets[0][0], 4, lambda s: s, shuffle=False,
                                    n_workers=2, drop_last=False)
    assert len(unshuffled) == 1 and len(list(unshuffled)) == 1
