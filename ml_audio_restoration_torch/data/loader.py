"""Batching data loader with background prefetch.

The port's own copy of ml_audio_restoration_tpu/data/loader.py (collate,
DataLoader, train_val_split), with the same numpy generators: from one
seed both packages yield identical batches, which torch's DataLoader
would not. One background thread decodes whole batches, in order, into a
bounded queue; items are read sequentially on that thread because the
datasets draw chunk starts from one seeded generator. A dataset with
`getitems` reads a batch in one call (the JAX package's batch route),
its rows spread over `num_workers` threads once the starts are drawn, so
every worker count gives the same batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..utils.profiling import annotate


def collate(items: Sequence[dict]) -> dict:
    """Stack a list of {key: array|scalar} into {key: [B, ...]}."""
    return {key: np.stack([np.asarray(it[key]) for it in items])
            for key in items[0]}


class DataLoader:
    """Iterates batches over a dataset with shuffling and prefetch.
    drop_last=True keeps every batch the same shape."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 4,
                 drop_last: bool = True,
                 indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(dataset)))
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.indices) // self.batch_size
        if not self.drop_last and len(self.indices) % self.batch_size:
            n += 1
        return max(n, 0)

    def _batches(self):
        order = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order) - (self.batch_size - 1
                                        if self.drop_last else 0),
                       self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        batches = list(self._batches())
        if not batches:
            return iter(())
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        getitems = getattr(self.dataset, "getitems", None)

        def put(item) -> bool:
            # an abandoned iterator stops draining the queue; poll the stop
            # flag so the worker thread never blocks forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    if getitems is not None:
                        items = getitems([int(j) for j in batch_idx],
                                         threads=self.num_workers)
                    else:
                        items = [self.dataset[int(j)] for j in batch_idx]
                    if not put(collate(items)):
                        return
            except BaseException as e:  # raised on the consumer side
                put(e)

        t = threading.Thread(target=worker, daemon=True)

        def gen():
            # started here, not in __iter__: an iterator that is never
            # advanced never runs this body, so its finally would never set
            # the stop flag for an eagerly started worker
            t.start()
            try:
                # one item a batch, or the worker's exception
                for _ in batches:
                    with annotate("loader.wait"):
                        item = q.get()
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()

        return gen()


def train_val_split(dataset, val_fraction: float, seed: int = 0):
    """Random index split: (train indices, validation indices)."""
    n = len(dataset)
    order = np.random.default_rng(seed).permutation(n)
    n_val = int(n * val_fraction)
    return order[n_val:], order[:n_val]


def prepare_dataset(data_dir, batch_size: int = 16, num_workers: int = 4,
                    **dataset_kwargs) -> DataLoader:
    """A RestorationDataset over `data_dir` (dataset_kwargs passed on) in
    a shuffling DataLoader."""
    from .datasets import RestorationDataset

    dataset = RestorationDataset(data_dir, **dataset_kwargs)
    return DataLoader(dataset, batch_size, shuffle=True,
                      num_workers=num_workers)
