"""Serving with host IO: what ``bench.py --host-io`` builds around the
executor (``bench.py:535-682``), as functions a bench can call.

Frames come from disk as a vehicle's node would get them, through
``serving/executor.ServingExecutor``:

- ``raw_source``: batches of raw uint8 camera frames from a memory-mapped
  ``.npy`` ring (``bench.py:625-629``);
- ``png_source``: the same frames as PNG files, decoded on the host by
  ``data/image_io.read_image`` through PIL (``bench.py:631-638``; the JAX
  package's libpng codec is not ported).

``host_io_pipeline`` serves the pair of ``configs.HOST_IO``, the two
int8-chain requests of ``configs.CHAIN_INT8`` on the same batch, with the
YOLACT's masks binarised and bit-packed on the device
(``ops.masks.pack_masks``, ``jnp.packbits(mask > 0.5, axis=-1)`` in
``bench.py:606-620``), the bitmaps the reference node publishes.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import pathlib
from typing import Callable, Iterator, Tuple, Union

import numpy as np
import torch

from tauv_vision_tpu_torch.configs import HOST_IO
from tauv_vision_tpu_torch.data.image_io import read_image, write_png
from tauv_vision_tpu_torch.ops.masks import pack_masks

PathLike = Union[str, pathlib.Path]
RAW_NAME = "frames.npy"
PNG_DIR = "png"


def write_frames(directory: PathLike, frames: np.ndarray) -> Tuple[pathlib.Path, pathlib.Path]:
    """Write uint8 [N, H, W, 3] ``frames`` as ``bench.py --host-io`` does:
    one ``.npy`` ring and one PNG a frame (``{i:06d}.png``, encoded on a
    pool of threads: PIL's encoder releases the GIL).  Returns (the ring's
    path, the PNG directory)."""
    directory = pathlib.Path(directory)
    raw_path = directory / RAW_NAME
    np.save(raw_path, frames)
    png_dir = directory / PNG_DIR
    png_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(lambda i: write_png(png_dir / f"{i:06d}.png", frames[i]),
                      range(len(frames))))
    return raw_path, png_dir


def raw_source(path: PathLike, batch: int, reps: int = 1) -> Iterator[np.ndarray]:
    """``reps`` passes over the memory-mapped frames of ``path`` in
    batches of ``batch`` (a short last batch is dropped)."""
    ring = np.load(path, mmap_mode="r")
    for _ in range(reps):
        for i in range(len(ring) // batch):
            yield np.asarray(ring[i * batch:(i + 1) * batch])


def png_source(directory: PathLike, batch: int, reps: int = 1) -> Iterator[np.ndarray]:
    """``reps`` passes over the PNG files of ``directory`` (sorted by name),
    decoded on this thread, in batches of ``batch``."""
    names = sorted(pathlib.Path(directory).iterdir())
    for _ in range(reps):
        for i in range(len(names) // batch):
            yield np.stack([read_image(p) for p in names[i * batch:(i + 1) * batch]])


def host_io_pipeline(cn_pipeline: Callable, yl_pipeline: Callable,
                     threshold: float = HOST_IO.mask_threshold) -> Callable:
    """``fn(frames) -> (Detections, YolactDetections)``: both requests on
    the same batch, the YOLACT's masks [B, K, h, w] replaced by their
    bitmaps ``pack_masks(mask, threshold)`` [B, K, h, ceil(w / 8)]
    uint8."""
    def pipeline(frames):
        cn_out, yl_out = cn_pipeline(frames), yl_pipeline(frames)
        with torch.inference_mode():
            return cn_out, dataclasses.replace(yl_out, mask=pack_masks(yl_out.mask, threshold))

    return pipeline
