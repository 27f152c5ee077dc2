"""The port's process-group plumbing (``parallel/distributed.py``,
``parallel/mesh.py``) against the JAX package's contracts
(``tests/test_distributed.py``).

- ``initialize``: the single-process no-op (no address), a world of 1
  (no-op), an address without the world size and rank (raises, as JAX's
  does), an unnamed backend (raises).
- ``host_local_batch_slice``: the whole batch in one process; rank 2 of
  4 on 32 rows gives rows 16-24 and 33 rows raise, beside JAX's own
  answer with the same process count and index.
- ``shard_batch``: rank 2 of 4's rows of an array and of a truth
  dataclass (None fields kept), 33 rows raising.
- On 2 spawned gloo ranks (127.0.0.1, one torch thread each):
  ``global_array_from_host_local`` gathers every rank's rows bit for bit
  (f32 and bool), ``replicate`` gives every rank rank 0's parameters and
  buffers, ``Mesh.psum``'s forward is the sum and its backward the sum
  of the ranks' gradients (the derivative of the summed losses), and
  ``Mesh.pmax`` is the maximum.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tauv_vision_tpu.parallel import distributed as jax_distributed
from tauv_vision_tpu_torch.parallel import distributed
from tauv_vision_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    create_mesh,
    parallel,
    psum,
    shard_batch,
)
from torch_dp_ranks import mesh_checks

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_torchrun(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)


def test_torch_initialize_single_process_noop(no_torchrun):
    assert distributed.initialize() is False
    assert distributed.initialize("gloo") is False
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    mesh = create_mesh()
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    assert mesh.shape == {DATA_AXIS: 1} and DATA_AXIS == "data"
    assert not parallel(mesh) and not parallel(None)


def test_torch_initialize_world_of_one_noop(no_torchrun, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed.initialize("gloo") is False
    assert distributed.initialize("gloo", "localhost:1234", 1, 0) is False


def test_torch_initialize_address_without_rank_raises(no_torchrun, monkeypatch):
    with pytest.raises(ValueError, match="world size and rank"):
        distributed.initialize("gloo", address="127.0.0.1:1234")
    with pytest.raises(ValueError, match="world size and rank"):
        distributed.initialize("gloo", address="127.0.0.1:1234", world_size=2)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="world size and rank"):
        distributed.initialize("gloo")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize()


def test_torch_host_local_batch_slice_single_process(no_torchrun):
    s = distributed.host_local_batch_slice(32)
    assert (s.start, s.stop) == (0, 32)


def test_torch_host_local_batch_slice_multiprocess(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    s = distributed.host_local_batch_slice(32)
    assert (s.start, s.stop) == (16, 24)
    assert s == jax_distributed.host_local_batch_slice(32)
    with pytest.raises(ValueError):
        distributed.host_local_batch_slice(33)


@dataclasses.dataclass
class _Truth:
    valid: object
    box: object
    extra: object = None


def test_torch_shard_batch_takes_the_rank_rows():
    mesh = Mesh(4, 2, torch.device("cpu"))
    x = np.arange(32 * 3, dtype=np.float32).reshape(32, 3)
    np.testing.assert_array_equal(shard_batch(x, mesh).numpy(), x[16:24])
    truth = _Truth(valid=np.arange(32) % 2 == 0, box=x)
    local = shard_batch(truth, mesh)
    np.testing.assert_array_equal(local.valid.numpy(), truth.valid[16:24])
    np.testing.assert_array_equal(local.box.numpy(), x[16:24])
    assert local.extra is None
    with pytest.raises(ValueError):
        shard_batch(np.zeros((33, 2)), mesh)
    one = Mesh(1, 0, torch.device("cpu"))
    np.testing.assert_array_equal(shard_batch(x, one).numpy(), x)


def test_torch_collectives_without_a_mesh_are_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert psum(x, None) is x
    assert psum(x, Mesh(1, 0, torch.device("cpu"))) is x
    assert distributed.global_array_from_host_local(x, None) is x


def test_torch_collectives_on_two_ranks():
    results = distributed.spawn(mesh_checks, 2)
    for rank, got in enumerate(results):
        assert got["rank"] == rank
        np.testing.assert_array_equal(got["gathered"], got["want_gathered"])
        np.testing.assert_array_equal(got["gathered_bool"], got["want_bool"])
        assert got["gathered_dtypes"] == ["torch.float32", "torch.bool"]
        for name, value in got["replicated"].items():
            np.testing.assert_array_equal(value, results[0]["replicated"][name], err_msg=name)
        np.testing.assert_allclose(got["psum"], got["want_psum"], rtol=1e-6)
        np.testing.assert_allclose(got["grad"], got["want_grad"], rtol=1e-6)
        np.testing.assert_array_equal(got["pmax"], got["want_pmax"])
