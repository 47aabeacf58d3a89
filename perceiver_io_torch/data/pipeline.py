"""Host-side batching (the port's subset of ``perceiver_io_tpu/data/pipeline.py``):
``resolve_bucket_width`` and a ``DataLoader`` with a seeded shuffle, batching
and collation. Length-sorted windows, width-bucketed batches, multi-host
sharding and prefetch threads are not ported."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


def resolve_bucket_width(length: int, widths: Sequence[int]) -> int:
    """Smallest of the (sorted, ascending) ``widths`` holding ``length``;
    lengths beyond the final width (the cap) truncate to it."""
    cap = widths[-1]
    length = min(max(int(length), 1), cap)
    return next(w for w in widths if w >= length)


class DataLoader:
    """Minibatch iterator over an indexable dataset: each iteration is one
    epoch, shuffled from (seed, epoch) as the JAX package's loader does, so
    both see the same batches in the same order."""

    def __init__(self, dataset, batch_size: int, collate: Callable[[list], Batch],
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(np.uint32(self.seed) + np.uint32(epoch))
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Batch]:
        idx = self._epoch_indices(self.epoch)
        self.epoch += 1
        stop = len(idx) - self.batch_size + 1 if self.drop_last else len(idx)
        for start in range(0, max(stop, 0), self.batch_size):
            yield self.collate([self.dataset[int(i)] for i in idx[start:start + self.batch_size]])
