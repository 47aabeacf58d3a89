"""Host-side batching (the port's single-process subset of
``perceiver_io_tpu/data/pipeline.py``): ``resolve_bucket_width`` and a
``DataLoader`` with a seeded shuffle, length-sorted windows, width-bucketed
batches, batching, collation, a decode pool and a mid-epoch ``skip_next``.
Multi-host sharding, dispatch groups and prefetch threads are not part of
it: for one seed it yields the JAX loader's batches, widths and order with
one shard and a group size of 1."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

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
    both see the same batches in the same order.

    ``sort_key`` and ``sort_window``: within each window of ``sort_window``
    batches of the shuffled order, the examples are sorted by ``sort_key``
    (token lengths), so batches are length-homogeneous; the batches of a
    window are then permuted, from (seed, epoch), so no short-to-long
    curriculum shows. ``group_widths``: the bucket widths; each batch is
    collated at the smallest one holding its longest example
    (``collate(examples, width=...)``). ``num_workers``: the threads that
    read a batch's examples (``dataset[i]``: decoding an image file, say),
    in the batch's order, so every ``num_workers`` gives the same batches: a
    dataset whose reads draw a seed each (``draw_seed()`` and ``read(i,
    seed)``, an augmenting image folder) has the batch's seeds drawn here,
    in order, before the threads read. Threads, as the JAX loader's pool:
    PIL and numpy release the GIL in their hot parts."""

    def __init__(self, dataset, batch_size: int, collate: Callable[..., Batch],
                 shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 sort_key: Optional[np.ndarray] = None, sort_window: int = 0,
                 group_widths: Optional[Sequence[int]] = None, num_workers: int = 0):
        if sort_window and sort_key is None:
            raise ValueError("sort_window requires a sort_key array")
        if sort_key is not None and len(sort_key) != len(dataset):
            raise ValueError(f"sort_key length {len(sort_key)} != dataset size {len(dataset)}")
        if group_widths is not None and sort_key is None:
            raise ValueError("group_widths requires a sort_key of token lengths")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.sort_key = None if sort_key is None else np.asarray(sort_key)
        self.sort_window = sort_window
        self.group_widths = None if group_widths is None else sorted(int(w) for w in group_widths)
        self.num_workers = num_workers
        self.epoch = 0
        self._skip = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(np.uint32(self.seed) + np.uint32(epoch))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.sort_key is not None and self.sort_window > 0:
            idx = self._length_grouped(idx, epoch)
        return idx

    def _length_grouped(self, idx: np.ndarray, epoch: int) -> np.ndarray:
        window = max(self.sort_window, 1) * self.batch_size
        rng = np.random.default_rng((np.uint32(self.seed) ^ np.uint32(0x9E3779B9))
                                    + np.uint32(epoch))
        batches, tails = [], []
        for start in range(0, len(idx), window):
            win = idx[start: start + window]
            win = win[np.argsort(self.sort_key[win], kind="stable")]
            nb = len(win) // self.batch_size
            batches.extend(win[i * self.batch_size: (i + 1) * self.batch_size]
                           for i in range(nb))
            tails.append(win[nb * self.batch_size:])  # only the last window's is non-empty
        per_win = max(self.sort_window, 1)
        out = []
        for start in range(0, len(batches), per_win):
            chunk = batches[start: start + per_win]
            out.extend(chunk[j] for j in rng.permutation(len(chunk)))
        out.extend(tails)
        return np.concatenate(out) if out else idx

    def _batch_width(self, batch_idx: np.ndarray) -> int:
        """The bucket width of a batch: its longest example's."""
        longest = int(self.sort_key[batch_idx].max(initial=1))
        return resolve_bucket_width(longest, self.group_widths)

    def skip_next(self, num_batches: int) -> None:
        """Skip the first ``num_batches`` of the next iteration (a mid-epoch
        resume): the skipped examples are never loaded, and the rest are
        what an uninterrupted run would see."""
        self._skip = num_batches

    def _read(self, pool, batch_idx: np.ndarray) -> list:
        if pool is None:
            return [self.dataset[int(i)] for i in batch_idx]
        draw = getattr(self.dataset, "draw_seed", None)
        if draw is None:
            return list(pool.map(self.dataset.__getitem__, map(int, batch_idx)))
        seeds = [draw() for _ in batch_idx]
        return list(pool.map(self.dataset.read, map(int, batch_idx), seeds))

    def __iter__(self) -> Iterator[Batch]:
        # the epoch advances up front, so a loop that breaks early still
        # moves the next iteration to a fresh shuffle
        epoch, skip = self.epoch, self._skip
        self.epoch += 1
        self._skip = 0
        idx = self._epoch_indices(epoch)
        stop = len(idx) - self.batch_size + 1 if self.drop_last else len(idx)
        pool = (ThreadPoolExecutor(self.num_workers, thread_name_prefix="loader")
                if self.num_workers > 0 else None)
        try:
            for start in range(skip * self.batch_size, max(stop, 0), self.batch_size):
                batch_idx = idx[start: start + self.batch_size]
                examples = self._read(pool, batch_idx)
                if self.group_widths is not None:
                    yield self.collate(examples, width=self._batch_width(batch_idx))
                else:
                    yield self.collate(examples)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
