"""The port's serving executor (``serving/executor.py``) against the JAX
package's (``tauv_vision_tpu/serving/executor.py``), on the CPU.

JAX's three cases (``tests/test_executor.py``) run through both
executors: the same toy pipeline, written once in JAX and once in
PyTorch, on the same uint8 batches.  Its sums and scalings are exact in
f32 (integer sums below 2^24), so the outputs are held bit for bit.  Then
what the port's contract adds: closing the generator early stops the
three threads, an error inside the pipeline at batch k comes after the k
results ahead of it, the detections' dataclasses come back with numpy
leaves, and at most ``prefetch`` batches wait ahead of compute.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.serving.executor import ServingExecutor as JaxServingExecutor
from tauv_vision_tpu.serving.yolact_decode import YolactDetections as JaxYolactDetections
from tauv_vision_tpu_torch.serving.executor import THREAD_PREFIX, ServingExecutor, tree_map
from tauv_vision_tpu_torch.serving.yolact_decode import YolactDetections

THREADS_GONE_S = 2.0


def _jax_pipeline(variables, frames):
    return {"sum": frames.astype(jnp.float32).sum(axis=(1, 2, 3)),
            "scaled": frames.astype(jnp.float32) * variables["scale"]}


def _port_pipeline(scale):
    def pipeline(frames):
        with torch.inference_mode():
            x = frames.to(torch.float32)
            return {"sum": x.sum(dim=(1, 2, 3)), "scaled": x * scale}

    return pipeline


def _batches(n, shape=(2, 4, 4, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, shape, np.uint8) for _ in range(n)]


def _executor_threads():
    return [t for t in threading.enumerate() if t.name.startswith(THREAD_PREFIX)]


def _wait_threads_gone():
    start = time.perf_counter()
    while _executor_threads() and time.perf_counter() - start < THREADS_GONE_S:
        time.sleep(0.01)
    return _executor_threads()


def test_torch_executor_matches_sequential_and_jax():
    batches = _batches(7)
    want = list(JaxServingExecutor(jax.jit(_jax_pipeline), {"scale": jnp.asarray(2.0)},
                                   prefetch=2).run(iter(batches)))
    pipeline = _port_pipeline(2.0)
    got = list(ServingExecutor(pipeline, prefetch=2, device="cpu").run(iter(batches)))
    assert len(got) == len(want) == len(batches)
    for out, ref, frames in zip(got, want, batches):
        seq = pipeline(torch.from_numpy(frames))
        for key in ("sum", "scaled"):
            assert isinstance(out[key], np.ndarray)
            np.testing.assert_array_equal(out[key], np.asarray(ref[key]))
            np.testing.assert_array_equal(out[key], seq[key].numpy())
    assert not _wait_threads_gone()


def test_torch_executor_device_outputs():
    batches = [np.zeros((1, 2, 2, 3), np.uint8)] * 3
    want = list(JaxServingExecutor(jax.jit(_jax_pipeline), {"scale": jnp.asarray(1.0)},
                                   prefetch=1).run(iter(batches), to_numpy=False))
    got = list(ServingExecutor(_port_pipeline(1.0), prefetch=1, device="cpu")
               .run(iter(batches), to_numpy=False))
    assert len(got) == len(want) == 3
    assert all(isinstance(o["sum"], jax.Array) for o in want)
    assert all(isinstance(o["sum"], torch.Tensor) and o["sum"].device.type == "cpu"
               for o in got)
    for out, ref in zip(got, want):
        np.testing.assert_array_equal(out["scaled"].numpy(), np.asarray(ref["scaled"]))


def test_torch_executor_propagates_input_errors():
    """A source that raises after one batch: JAX raises; the port yields
    the one batch ahead of the error, then raises it."""
    def bad_iter():
        yield np.zeros((1, 2, 2, 3), np.uint8)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(JaxServingExecutor(jax.jit(_jax_pipeline), {"scale": jnp.asarray(1.0)},
                                prefetch=2).run(bad_iter()))
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for out in ServingExecutor(_port_pipeline(1.0), prefetch=2, device="cpu").run(bad_iter()):
            got.append(out)
    assert len(got) == 1
    np.testing.assert_array_equal(got[0]["sum"], np.zeros(1, np.float32))
    assert not _wait_threads_gone()


@pytest.mark.parametrize("k", [0, 3])
def test_torch_executor_pipeline_error_after_k_results(k):
    batches = _batches(6, seed=1)
    inner = _port_pipeline(1.0)
    calls = []

    def pipeline(frames):
        calls.append(1)
        if len(calls) == k + 1:
            raise ValueError(f"batch {k}")
        return inner(frames)

    got = []
    with pytest.raises(ValueError, match=f"batch {k}"):
        for out in ServingExecutor(pipeline, prefetch=2, device="cpu").run(iter(batches)):
            got.append(out)
    assert len(got) == k
    for out, frames in zip(got, batches):
        np.testing.assert_array_equal(out["sum"], frames.astype(np.float32).sum(axis=(1, 2, 3)))
    assert not _wait_threads_gone()


@pytest.mark.parametrize("how", ["close", "break", "gc"])
def test_torch_executor_early_close_stops_threads(how):
    """Closed after 2 of 20 batches, with the queues full: no executor
    thread is left after 2 s."""
    batches = _batches(20, seed=2)
    gen = ServingExecutor(_port_pipeline(1.0), prefetch=2, device="cpu").run(iter(batches))
    if how == "break":
        for i, _ in enumerate(gen):
            if i == 1:
                break
        gen.close()
    else:
        next(gen)
        next(gen)
        time.sleep(0.3)   # let the threads fill their queues
        assert _executor_threads()
        if how == "close":
            gen.close()
        else:
            del gen
    assert not _wait_threads_gone()


def test_torch_executor_dataclass_outputs():
    """A pipeline that returns the detections' dataclass inside a tuple:
    every tensor leaf comes back as numpy, as JAX's ``tree_map`` brings
    back JAX's ``YolactDetections``; ``None`` stays ``None``."""
    batches = _batches(3, seed=3)

    def fields(x, label):
        return dict(valid=x[:, 0, 0, 0] > 100, score=x[:, 0, 0, :].sum(-1), label=label,
                    box=x[:, :1, 0, :], mask=x[:, :2, :2, 0])

    def jax_pipeline(variables, frames):
        x = frames.astype(jnp.float32)
        return JaxYolactDetections(**fields(x, frames[:, 0, 0, :2].astype(jnp.int32))), x.sum()

    def port_pipeline(frames):
        x = frames.to(torch.float32)
        return YolactDetections(**fields(x, frames[:, 0, 0, :2].to(torch.int32))), x.sum(), None

    want = list(JaxServingExecutor(jax.jit(jax_pipeline), {}).run(iter(batches)))
    got = list(ServingExecutor(port_pipeline, device="cpu").run(iter(batches)))
    assert len(got) == len(want) == 3
    for (dets, total, nothing), (ref, ref_total) in zip(got, want):
        assert isinstance(dets, YolactDetections) and nothing is None
        for name in ("valid", "score", "label", "box", "mask"):
            value = getattr(dets, name)
            assert isinstance(value, np.ndarray), name
            np.testing.assert_array_equal(value, np.asarray(getattr(ref, name)))
        np.testing.assert_array_equal(total, np.asarray(ref_total))


def test_torch_executor_prefetch_bound():
    """With the pipeline blocked on its first batch, the source is read
    ``prefetch`` batches ahead of it, plus the one the upload thread holds
    while it waits for room: as JAX's executor, whose queues are as
    deep."""
    for prefetch in (1, 3):
        release = threading.Event()
        pulled = []

        def source():
            for frames in _batches(12, seed=4):
                pulled.append(1)
                yield frames

        def pipeline(frames):
            release.wait(timeout=10)
            return frames.sum()

        gen = ServingExecutor(pipeline, prefetch=prefetch, device="cpu").run(source())
        first = threading.Thread(target=lambda: next(gen))
        first.start()
        time.sleep(0.5)
        assert len(pulled) == 1 + prefetch + 1, (prefetch, len(pulled))
        release.set()
        first.join(timeout=10)
        assert not first.is_alive()
        gen.close()
        assert not _wait_threads_gone()


def test_torch_tree_map_walks_the_port_outputs():
    dets = YolactDetections(*(torch.full((1,), float(i)) for i in range(5)))
    out = tree_map(lambda t: t + 1, {"a": (dets, [torch.zeros(1)]), "b": 3})
    assert isinstance(out["a"], tuple) and isinstance(out["a"][1], list) and out["b"] == 3
    assert [float(getattr(out["a"][0], f)) for f in ("valid", "score", "label", "box",
                                                     "mask")] == [1, 2, 3, 4, 5]
