"""Host data pipeline: concat datasets + shuffled, prefetched batch loader
(a copy of ``tauv_vision_tpu/data/loader.py``: the same batches in the
same order for a seed and epoch).

Replaces the reference's torch DataLoader(num_workers=N) + ConcatDataset
(yolact/scripts/train.py:465-488, centernet/scripts/train.py:198-223)
with a thread-pool loader: sample loading/augmentation is numpy/cv2 (GIL
released inside cv2/PIL), and batches are prefetched ahead of the
device.  The batches are host numpy arrays; the trainer moves them to
the card through pinned memory (``train/trainer.py``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Sequence

import numpy as np


class ConcatDataset:
    def __init__(self, datasets: Sequence[Any]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, i: int):
        dataset_i = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[dataset_i][i - int(self._offsets[dataset_i])]


class BatchLoader:
    """Iterable over collated batches with background prefetch.

    ``collate_fn(samples) -> batch`` receives ``batch_size`` raw samples.
    Incomplete trailing batches are dropped (static shapes).
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        collate_fn: Callable[[List[Any]], Any],
        shuffle: bool = True,
        n_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.n_workers = max(1, n_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _index_batches(self) -> List[List[int]]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(indices)
        batches = [
            list(indices[i: i + self.batch_size])
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self) -> Iterator[Any]:
        self._epoch += 1
        batches = self._index_batches()
        out_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def load_batch(batch_indices):
            samples = [self.dataset[i] for i in batch_indices]
            return self.collate_fn(samples)

        def put(item) -> bool:
            # A consumer that stops early (an epoch capped below the
            # loader's length) takes no more items: give up rather than
            # wait on a full queue forever.
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(self.n_workers) as pool:
                futures = [pool.submit(load_batch, b) for b in batches]
                for future in futures:
                    if stop.is_set():
                        future.cancel()
                        continue
                    try:
                        item = future.result()
                    except Exception as e:  # surface loader errors
                        put(e)
                        stop.set()
                        continue
                    put(item)
            put(StopIteration)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is StopIteration:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def cycle(loader: BatchLoader) -> Iterator[Any]:
    """Infinite batch stream (the reference trains with
    itertools.cycle(dataloader) capped at epoch_n_batches,
    yolact/scripts/train.py:230-234)."""
    while True:
        yield from loader
