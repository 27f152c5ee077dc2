"""The port's sharded loaders against the JAX package's.

- ``data/grain_loader.make_grain_loader`` (a ``DataLoader`` with worker
  processes, no grain) against JAX's ``make_grain_loader`` (grain), with
  ``shuffle=False``, on ``tests/test_eval_data._make_pose_dataset``'s
  directory and on a dataset of 11 integers: for each shard (i, n) the
  port's batches equal grain's, bit for bit.  JAX's loader shards by
  ``ShardByJaxProcess``; the test gives it grain's ``ShardOptions(i, n)``
  instead, and the port the same rank and world.  Shards are disjoint
  and cover the records but the remainder; with shuffling the port's
  order is the same for a seed, another for another seed, and covers the
  shard's records each epoch; with worker processes the batches are those
  of the loader in this process.
- ``data/loader.BatchLoader(shard=(rank, world))``: the ranks' batch k,
  concatenated, is the JAX ``BatchLoader``'s batch k, epoch after epoch
  (shuffled), on the pose dataset and on integers.
"""

import numpy as np
import pytest

grain = pytest.importorskip("grain.python")

from tauv_vision_tpu.data import grain_loader as jax_grain_loader  # noqa: E402
from tauv_vision_tpu.data.dataset_dir import Split as JaxSplit  # noqa: E402
from tauv_vision_tpu.data.loader import BatchLoader as JaxBatchLoader  # noqa: E402
from tauv_vision_tpu.data.pose_dataset import PoseDataset as JaxPoseDataset  # noqa: E402
from tauv_vision_tpu.data.pose_dataset import (  # noqa: E402
    collate_pose_samples as jax_collate_pose_samples,
)
from tauv_vision_tpu_torch.data import grain_loader  # noqa: E402
from tauv_vision_tpu_torch.data.dataset_dir import Split  # noqa: E402
from tauv_vision_tpu_torch.data.loader import BatchLoader  # noqa: E402
from tauv_vision_tpu_torch.data.pose_dataset import (  # noqa: E402
    PoseDataset,
    collate_pose_samples,
)
from tauv_vision_tpu_torch.parallel import distributed  # noqa: E402
from test_eval_data import _make_pose_dataset, _object_config  # noqa: E402
from torch_parity import port_object_config  # noqa: E402

SHARDS = [(0, 1), (0, 2), (1, 2), (0, 3), (2, 3)]


class Integers:
    """Records 0..n-1, each a one-element array."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i], np.int64)


def stack(samples):
    return np.concatenate(samples)


def pose_collate(samples):
    return collate_pose_samples(samples, 4, 8)


def jax_pose_collate(samples):
    return jax_collate_pose_samples(samples, 4, 8)


@pytest.fixture(scope="module")
def pose_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pose")
    _make_pose_dataset(root, n=4)
    return root


def pose_datasets(root):
    jax_oc = _object_config()
    oc = port_object_config(jax_oc)
    return (PoseDataset(root, Split.TRAIN, oc.label_id_to_index, oc, None),
            JaxPoseDataset(root, JaxSplit.TRAIN, jax_oc.label_id_to_index, jax_oc, None))


def flat(batch):
    """A batch as a list of numpy arrays (an img and a truth dataclass, or
    an array)."""
    if isinstance(batch, tuple):
        img, truth = batch
        return [np.asarray(img)] + [np.asarray(v) for v in vars(truth).values() if v is not None]
    return [np.asarray(batch)]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gs, ws = flat(g), flat(w)
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def port_batches(monkeypatch, shard, dataset, batch_size, collate, **kwargs):
    monkeypatch.setattr(distributed, "process_index", lambda: shard[0])
    monkeypatch.setattr(distributed, "process_count", lambda: shard[1])
    return list(grain_loader.make_grain_loader(dataset, batch_size, collate, **kwargs))


def jax_batches(monkeypatch, shard, dataset, batch_size, collate, **kwargs):
    monkeypatch.setattr(jax_grain_loader.grain, "ShardByJaxProcess",
                        lambda drop_remainder: grain.ShardOptions(
                            shard_index=shard[0], shard_count=shard[1],
                            drop_remainder=drop_remainder))
    return list(jax_grain_loader.make_grain_loader(dataset, batch_size, collate, **kwargs))


@pytest.mark.parametrize("shard", SHARDS[:3])
def test_torch_grain_loader_pose_batches_are_grains(monkeypatch, pose_dir, shard):
    port_ds, jax_ds = pose_datasets(pose_dir)
    got = port_batches(monkeypatch, shard, port_ds, 1, pose_collate, shuffle=False)
    want = jax_batches(monkeypatch, shard, jax_ds, 1, jax_pose_collate, shuffle=False)
    assert len(want) == 3 // shard[1]
    assert_batches_equal(got, want)


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shard", SHARDS)
def test_torch_grain_loader_integer_batches_are_grains(monkeypatch, shard, drop_remainder):
    kwargs = dict(shuffle=False, num_epochs=2, drop_remainder=drop_remainder)
    got = port_batches(monkeypatch, shard, Integers(11), 2, stack, **kwargs)
    want = jax_batches(monkeypatch, shard, Integers(11), 2, stack, **kwargs)
    assert_batches_equal(got, want)


@pytest.mark.parametrize("n", [2, 3])
def test_torch_grain_loader_shards_are_disjoint_and_cover(monkeypatch, n):
    seen = []
    for i in range(n):
        batches = port_batches(monkeypatch, (i, n), Integers(11), 1, stack, shuffle=True, seed=3)
        seen.append([int(b[0]) for b in batches])
    assert all(len(s) == 11 // n for s in seen)
    flat_seen = sorted(sum(seen, []))
    assert len(set(flat_seen)) == len(flat_seen) == n * (11 // n)


def test_torch_grain_loader_order_is_the_same_for_a_seed(monkeypatch):
    def run(seed, **kwargs):
        return [b.tolist() for b in port_batches(monkeypatch, (1, 2), Integers(11), 2, stack,
                                                 shuffle=True, seed=seed, num_epochs=3,
                                                 **kwargs)]

    first = run(7)
    assert first == run(7)
    assert first != run(8)
    assert first == run(7, worker_count=2)
    records = sorted(sum(first, []))
    # 3 epochs of the shard's 5 records, 15 in all: 7 whole batches of 2.
    assert len(records) == 14 and set(records) <= set(range(5, 10))
    epoch = sum(first, [])[:5]
    assert sorted(epoch) == list(range(5, 10))


@pytest.mark.parametrize("world", [2, 4])
def test_torch_batch_loader_shards_rebuild_the_jax_batches_integers(world):
    want_loader = JaxBatchLoader(Integers(10), 4, stack, shuffle=True, seed=5, n_workers=2)
    loaders = [BatchLoader(Integers(10), 4, stack, shuffle=True, seed=5, n_workers=2,
                           shard=(r, world)) for r in range(world)]
    for _ in range(3):   # epochs: each reshuffled
        want = list(want_loader)
        got = [list(loader) for loader in loaders]
        assert all(len(g) == len(want) == 2 for g in got)
        for k, w in enumerate(want):
            np.testing.assert_array_equal(np.concatenate([g[k] for g in got]), w)


def test_torch_batch_loader_shards_rebuild_the_jax_batches_pose(pose_dir):
    port_ds, jax_ds = pose_datasets(pose_dir)
    want_loader = JaxBatchLoader(jax_ds, 2, jax_pose_collate, shuffle=True, seed=1)
    loaders = [BatchLoader(port_ds, 2, pose_collate, shuffle=True, seed=1, shard=(r, 2))
               for r in range(2)]
    for _ in range(2):
        want = list(want_loader)
        got = [list(loader) for loader in loaders]
        assert len(want) == 1
        for k, w in enumerate(want):
            parts = [flat(g[k]) for g in got]
            for i, w_i in enumerate(flat(w)):
                np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]), w_i)


def test_torch_batch_loader_shard_needs_whole_batches():
    with pytest.raises(ValueError):
        BatchLoader(Integers(10), 3, stack, shard=(0, 2))
    with pytest.raises(ValueError):
        BatchLoader(Integers(10), 4, stack, shard=(2, 2))
    with pytest.raises(ValueError):
        BatchLoader(Integers(10), 4, stack, shard=(0, 2), drop_last=False)
