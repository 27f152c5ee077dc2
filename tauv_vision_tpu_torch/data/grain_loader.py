"""A loader with worker processes and per-rank sharding (counterpart of
``tauv_vision_tpu/data/grain_loader.py``).

The JAX package builds it on grain; the port uses no grain (the card's
machine has none) and builds the same contract on
``torch.utils.data.DataLoader``: grain's ``IndexSampler`` order (each
rank's contiguous block of the records, as grain's ``ShardByJaxProcess``
cuts it; the epochs one stream, each shuffled anew from the seed; the
stream cut into batches; with ``drop_remainder``, the default, the
records past an even split and the last partial batch dropped), the
framework's padding collate as the batch function, and
``worker_count`` worker processes.  Without shuffling its batches are
grain's, shard for shard; with it, the order is the port's own
(a numpy permutation a seed and epoch), the same on every run.
"""

from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch.utils.data

from tauv_vision_tpu_torch.parallel import distributed


def shard_range(num_records: int, shard_index: int, shard_count: int,
                drop_remainder: bool) -> range:
    """The records of one shard: grain's even split, contiguous blocks,
    the first ``num_records % shard_count`` one longer unless
    ``drop_remainder`` (then every block has ``num_records //
    shard_count``)."""
    per, extra = divmod(num_records, shard_count)
    if drop_remainder:
        return range(shard_index * per, (shard_index + 1) * per)
    start = shard_index * per + min(shard_index, extra)
    return range(start, start + per + (shard_index < extra))


class ShardedBatchSampler(torch.utils.data.Sampler):
    """Batches of record indices of one shard (``shard_range``), as grain's
    ``IndexSampler`` streams them: the shard's records over and over, one
    pass an epoch (each shuffled from ``(seed, epoch)`` when ``shuffle``),
    as many as grain reads for ``num_epochs`` (None: forever), cut into
    ``batch_size``.  That is ``num_epochs`` passes with
    ``drop_remainder``; without it, every shard reads ``num_epochs *
    num_records // shard_count`` (grain's ``DataLoader`` length), which
    may end inside a pass."""

    def __init__(self, num_records: int, batch_size: int, shard_index: int, shard_count: int,
                 shuffle: bool, seed: int, num_epochs: Optional[int], drop_remainder: bool):
        self.records = shard_range(num_records, shard_index, shard_count, drop_remainder)
        self.batch_size, self.shuffle, self.seed = batch_size, shuffle, seed
        self.drop_remainder = drop_remainder
        if num_epochs is None:
            self.total = None
        elif drop_remainder:
            self.total = len(self.records) * num_epochs
        else:
            self.total = num_epochs * num_records // shard_count

    def _stream(self) -> Iterator[int]:
        passes = itertools.count()
        stream = itertools.chain.from_iterable(self._pass(epoch) for epoch in passes)
        return stream if self.total is None else itertools.islice(stream, self.total)

    def _pass(self, epoch: int) -> Iterator[int]:
        order = np.asarray(self.records)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        return (int(i) for i in order)

    def __iter__(self) -> Iterator[List[int]]:
        stream = self._stream()
        while True:
            batch = list(itertools.islice(stream, self.batch_size))
            if len(batch) < self.batch_size and (self.drop_remainder or not batch):
                return
            yield batch

    def __len__(self) -> int:
        if self.total is None:
            raise TypeError("an endless sampler has no length")
        if self.drop_remainder:
            return self.total // self.batch_size
        return -(-self.total // self.batch_size)


def make_grain_loader(
    dataset: Any,
    batch_size: int,
    collate_fn: Callable[[Sequence[Any]], Any],
    *,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: Optional[int] = 1,
    worker_count: int = 0,
    shard_by_process: bool = True,
    drop_remainder: bool = True,
):
    """A ``DataLoader`` over a framework dataset, with the JAX function's
    arguments.

    - ``worker_count > 0`` loads in that many worker processes (their
      batches arrive in order), 0 in this process;
    - ``shard_by_process`` gives each rank of the process group
      (``parallel.distributed``) a disjoint block of the records, so that
      each rank reads only its own (one shard when there is no group);
    - ``batch_size`` is the rank's batch.
    """
    shard = ((distributed.process_index(), distributed.process_count()) if shard_by_process
             else (0, 1))
    sampler = ShardedBatchSampler(len(dataset), batch_size, *shard, shuffle=shuffle, seed=seed,
                                  num_epochs=num_epochs, drop_remainder=drop_remainder)
    return torch.utils.data.DataLoader(dataset, batch_sampler=sampler,
                                       collate_fn=functools.partial(_collate, collate_fn),
                                       num_workers=worker_count)


def _collate(collate_fn, samples):
    return collate_fn(list(samples))
