"""Pipelined serving executor: overlap host IO with device compute
(counterpart of ``tauv_vision_tpu/serving/executor.py``).

Three threads keep the pipe full, in order:

- upload: takes frame batches from the source and puts them on the
  device, at most ``prefetch`` batches ahead of compute;
- dispatch: calls the pipeline on each uploaded batch;
- download: brings each batch's outputs back to the host as numpy
  arrays (or, with ``to_numpy=False``, waits until they are computed).

On a CUDA device each stage has its own stream.  The upload thread
copies a batch into one of ``prefetch + 1`` pinned host buffers (a buffer
is reused only after the event of its last copy has completed), issues
the host-to-device copy ``non_blocking`` on the upload stream and records
an event.  The dispatch thread makes the compute stream wait on that
event and calls the pipeline under ``torch.cuda.stream(compute)``.  The
download thread makes the download stream wait on the compute stream's
event, copies every output into pinned host tensors and waits on its own
event before handing back numpy.  The current stream is per thread in
PyTorch, so each thread sets its own; and every tensor that crosses
streams is marked with ``record_stream``, so that the caching allocator
does not hand its block to another stream while a later stream still
reads it.  The copies never fall back to the compute stream or to a
synchronous path.

The pipeline is called from Python on the dispatch thread, which holds
the GIL while it launches kernels; the copies and event waits of the
other two threads release it.  How much of the upload overlaps compute
on a given card is measured (``chip_smoke.py``'s ``host_io`` phase), not
assumed.

On the CPU (``device="cpu"``) the same three threads run with plain
tensors and no streams.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from tauv_vision_tpu_torch.device import DEFAULT_DEVICE, resolve_device

THREAD_PREFIX = "ServingExecutor"
_POLL_S = 0.1


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of ``tree``: dataclasses (the detections),
    named tuples, tuples, lists and dicts are walked; any other leaf is
    kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype's torch dtype (a torch dtype as it is)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class _Failure:
    """A worker's exception, passed down the queues in the place of the
    batch it failed on, so that the results ahead of it come out first."""

    def __init__(self, error: BaseException):
        self.error = error


_END = object()


class ServingExecutor:
    """Stream batches through a pipeline with prefetch.

    Args:
      pipeline: ``fn(frames) -> outputs``, frames a uint8 [B, H, W, 3]
        tensor on ``device`` (the port's ``make_*_pipeline`` functions,
        whose upload is a no-op for a tensor already there); outputs any
        nesting of tensors in dataclasses, tuples, lists and dicts.
      prefetch: at most this many batches resident ahead of compute (2 =
        double buffering).
      device: the card unless the caller passes "cpu".
    """

    def __init__(self, pipeline: Callable[[torch.Tensor], Any], prefetch: int = 2,
                 device=DEFAULT_DEVICE):
        self._pipeline = pipeline
        self._prefetch = max(1, prefetch)
        self._device = resolve_device(device)

    def run(self, frames_iter: Iterable, to_numpy: bool = True) -> Iterator[Any]:
        """Yield the pipeline's outputs for each batch of ``frames_iter``
        (numpy arrays or host tensors), in order: every tensor a numpy
        array with ``to_numpy``, else a tensor on the device, computed.

        Closing the generator early (``close()``, ``break``, garbage
        collection) stops the three threads: they drain and exit instead
        of blocking on a full queue.  A worker's error is raised as soon
        as the results ahead of it in order have been yielded."""
        cuda = self._device.type == "cuda"
        stop = threading.Event()
        uploaded: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        dispatched: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        results: "queue.Queue" = queue.Queue(maxsize=self._prefetch)

        def put(q: "queue.Queue", item) -> bool:
            """``q.put`` that gives up once the generator is closed."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False

        def take(q: "queue.Queue"):
            """``q.get`` that gives up (returns ``_END``) once the generator
            is closed."""
            while not stop.is_set():
                try:
                    return q.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
            return _END

        def stage(name, source, work, sink, setup=None):
            """A thread that takes items from ``source``, passes ``work`` of
            each to ``sink`` and ends the stream with ``_END``, or with the
            ``_Failure`` it met or raised."""
            def body():
                last = _END
                try:
                    if setup is not None:
                        setup()
                    while not stop.is_set():
                        item = source()
                        if item is _END or isinstance(item, _Failure):
                            last = item
                            break
                        try:
                            out = work(item)
                        except Exception as e:  # raised by the generator, in order
                            last = _Failure(e)
                            break
                        if not put(sink, out):
                            return
                finally:
                    put(sink, last)

            threading.Thread(target=body, name=f"{THREAD_PREFIX}-{name}", daemon=True).start()

        frames_it = iter(frames_iter)

        def next_batch():
            try:
                return next(frames_it)
            except StopIteration:
                return _END
            except Exception as e:
                return _Failure(e)

        if cuda:
            index = (self._device.index if self._device.index is not None
                     else torch.cuda.current_device())
            streams = {name: torch.cuda.Stream(index)
                       for name in ("upload", "compute", "download")}
            ring = [None] * (self._prefetch + 1)   # (pinned buffer, event of its last copy)
            count = [0]

            def upload(frames):
                frames = frames if isinstance(frames, torch.Tensor) else np.asarray(frames)
                dtype = _torch_dtype(frames.dtype)
                slot = count[0] % len(ring)
                count[0] += 1
                buf = None
                if ring[slot] is not None:
                    buf, copied = ring[slot]
                    copied.synchronize()
                    if tuple(buf.shape) != tuple(frames.shape) or buf.dtype != dtype:
                        buf = None
                if buf is None:
                    buf = torch.empty(tuple(frames.shape), dtype=dtype, pin_memory=True)
                if isinstance(frames, torch.Tensor):
                    buf.copy_(frames)
                else:
                    np.copyto(buf.numpy(), frames)
                with torch.cuda.stream(streams["upload"]):
                    on_device = buf.to(index, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(streams["upload"])
                ring[slot] = (buf, copied)
                return on_device, copied

            def dispatch(item):
                frames, uploaded_event = item
                compute = streams["compute"]
                compute.wait_event(uploaded_event)
                frames.record_stream(compute)
                with torch.cuda.stream(compute):
                    out = self._pipeline(frames)
                    computed = torch.cuda.Event()
                    computed.record(compute)
                return out, computed

            def download(item):
                out, computed = item
                if not to_numpy:
                    computed.synchronize()
                    return out
                stream = streams["download"]
                stream.wait_event(computed)

                def to_host(t):
                    t.record_stream(stream)
                    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host.copy_(t, non_blocking=True)
                    return host

                with torch.cuda.stream(stream):
                    host = tree_map(to_host, out)
                    copied = torch.cuda.Event()
                    copied.record(stream)
                copied.synchronize()
                return tree_map(torch.Tensor.numpy, host)

            def set_device():
                torch.cuda.set_device(index)
        else:
            def upload(frames):
                if not isinstance(frames, torch.Tensor):
                    frames = np.asarray(frames)
                    frames = torch.from_numpy(frames if frames.flags.writeable
                                              else frames.copy())
                return frames.to(self._device)

            def dispatch(frames):
                return self._pipeline(frames)

            def download(out):
                return tree_map(torch.Tensor.numpy, out) if to_numpy else out

            set_device = None

        stage("upload", next_batch, upload, uploaded, set_device)
        stage("dispatch", lambda: take(uploaded), dispatch, dispatched, set_device)
        stage("download", lambda: take(dispatched), download, results, set_device)
        try:
            while True:
                out = results.get()
                if out is _END:
                    return
                if isinstance(out, _Failure):
                    raise out.error
                if cuda and not to_numpy:
                    # The caller's stream reads the outputs from here on.
                    for t in _leaves(out):
                        t.record_stream(torch.cuda.current_stream(index))
                yield out
        finally:
            stop.set()
