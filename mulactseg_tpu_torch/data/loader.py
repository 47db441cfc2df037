"""Host-side batching and prefetch: the port's copy of
mulactseg_tpu/data/loader.py (collate, DataProvider).

A thread pool builds and collates samples while the card computes; the
batch index order is the JAX package's (one RandomState(seed), shuffle
per epoch, drop_last, infinite, and sampling with replacement for a
dataset smaller than the batch), so both packages see the same batches.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

PREFETCH = 4  # batches in flight
_ARRAY_KEYS = ("images", "labels", "target", "target_bits", "spx", "spmask",
               "spx_small", "images_weak", "spx_weak",
               "spmask_weak", "spx_small_weak")


def collate(samples: List[Dict]) -> Dict:
    """Stack the known array keys, list the rest (fnames)."""
    out: Dict = {}
    for k in samples[0].keys():
        vals = [s[k] for s in samples]
        if k in _ARRAY_KEYS or k.startswith("mseg_") or k == "nseg_lbl":
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    return out


class DataProvider:
    """Infinite (or single-epoch) iterator of collated numpy batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, infinite: bool = True,
                 num_workers: int = 4, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.infinite = infinite
        self.rng = np.random.RandomState(seed)
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self._iter = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        while True:
            idx = np.arange(len(self.dataset))
            if self.shuffle:
                self.rng.shuffle(idx)
            stop = len(idx) - (len(idx) % self.batch_size) if self.drop_last \
                else len(idx)
            if stop == 0 and self.infinite:
                # dataset smaller than the batch (the first round selected
                # superpixels of fewer images than a batch): sample with
                # replacement instead of spinning through empty epochs
                yield self.rng.choice(len(self.dataset), self.batch_size,
                                      replace=True)
                continue
            for i in range(0, stop, self.batch_size):
                yield idx[i:i + self.batch_size]
            if not self.infinite:
                return

    def _gen(self):
        pending = queue.Queue()
        batches = self._index_batches()

        def build(ids):
            return collate([self.dataset[int(j)] for j in ids])

        def submit_next():
            try:
                b = next(batches)
            except StopIteration:
                return False
            pending.put(self.pool.submit(build, b))
            return True

        alive = True
        for _ in range(PREFETCH):
            alive = submit_next() and alive
        while not pending.empty():
            fut = pending.get()
            yield fut.result()
            if alive:
                alive = submit_next()

    def __iter__(self):
        return self._gen()

    def __next__(self):
        if self._iter is None:
            self._iter = self._gen()
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = self._gen()
            return next(self._iter)

    def close(self):
        """Stop the worker threads (the iterator must not be used after)."""
        self.pool.shutdown(wait=True, cancel_futures=True)
