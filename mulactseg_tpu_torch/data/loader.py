"""Host-side batching and prefetch: the port's copy of
mulactseg_tpu/data/loader.py (collate, DataProvider).

The batch index order is the JAX package's (one RandomState(seed),
shuffle per epoch, drop_last, infinite, and sampling with replacement for
a dataset smaller than the batch), so both packages see the same batches.

Items of a dataset that reads files (`reads_files`, data/datasets.py) are
built in worker processes when num_workers >= 2, so that the Python
between their zlib, C++ and numpy calls does not take the GIL from the
train step's dispatch in the parent. The workers are started with
`spawn` once per process and reused by every provider; each provider
pickles its dataset to them once, and item i of the dataset goes to
worker i % num_workers, so each worker's decode cache holds its own share
of the files. An item's large arrays come back in one shared-memory
block, and a parent thread collates and frees them. The parent draws
every item's random transform parameters (dataset.draw) in item order
before it sends the item out, so the crops and flips are the draws of the
JAX package with one worker, whatever the number of workers. Other
datasets (the in-memory fixture) are built on a thread pool.
"""

from __future__ import annotations

import atexit
import itertools
import multiprocessing
import os
import pickle
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Dict, List, Optional

import numpy as np

from mulactseg_tpu_torch.parallel import mesh

PREFETCH = 4  # batches in flight, at least
_SHARED_BYTES = 1 << 16  # arrays a worker returns through shared memory
_SHARED_KEY = "_shared"
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


# -- worker processes ---------------------------------------------------------
_WORKERS: List[ProcessPoolExecutor] = []
_WORKERS_LOCK = threading.Lock()
_TOKENS = itertools.count()
_DATASETS: Dict[str, object] = {}  # in a worker: token -> dataset


def _worker_set(token: str, payload: bytes) -> None:
    _DATASETS[token] = pickle.loads(payload)


def _worker_drop(token: str) -> None:
    _DATASETS.pop(token, None)


class _Shared:
    """An item's large arrays, left by a worker in one shared-memory
    block: the block's name and, per key, the shape, dtype and offset."""

    def __init__(self, name: str, layout):
        self.name, self.layout = name, layout


def _worker_load(token: str, index: int, params):
    """Builds the item; its large arrays go back in one shared-memory
    block, not through the result pipe, whose 64 KB reads each wait for
    the parent's GIL while the parent dispatches a train step."""
    sample = _DATASETS[token].load(index, params)
    big = [k for k, v in sample.items()
           if isinstance(v, np.ndarray) and v.nbytes >= _SHARED_BYTES]
    if not big:
        return sample
    layout, size = [], 0
    for k in big:
        layout.append((k, sample[k].shape, sample[k].dtype.str, size))
        size += -(-sample[k].nbytes // 64) * 64
    shm = shared_memory.SharedMemory(create=True, size=size)
    for k, shape, dtype, offset in layout:
        np.ndarray(shape, dtype, buffer=shm.buf, offset=offset)[...] = \
            sample.pop(k)
    sample[_SHARED_KEY] = _Shared(shm.name, layout)
    shm.close()
    return sample


def _free_shared(sample: Dict) -> None:
    if _SHARED_KEY in sample:
        shm = shared_memory.SharedMemory(name=sample[_SHARED_KEY].name)
        shm.close()
        shm.unlink()


def _attach(sample: Dict, blocks: List) -> Dict:
    """The item with its shared arrays as views of their block, which is
    appended to `blocks`."""
    shared = sample.get(_SHARED_KEY)
    if shared is None:
        return sample
    shm = shared_memory.SharedMemory(name=shared.name)
    blocks.append(shm)
    out = {k: v for k, v in sample.items() if k != _SHARED_KEY}
    for k, shape, dtype, offset in shared.layout:
        out[k] = np.ndarray(shape, dtype, buffer=shm.buf, offset=offset)
    return out


def _collate_shared(samples: List[Dict]) -> Dict:
    """collate() over worker items, each shared block read once and
    freed (the views die with the call's argument list, before)."""
    blocks = []
    try:
        out = collate([_attach(s, blocks) for s in samples])
        # an array that collate lists (a statistics item's 'superpixel')
        # may be a view of a block: copied before the block goes
        for k, v in out.items():
            if isinstance(v, list):
                out[k] = [np.array(x) if isinstance(x, np.ndarray) else x
                          for x in v]
        return out
    finally:
        for shm in blocks:
            shm.close()
            shm.unlink()


def workers(n: int) -> List[ProcessPoolExecutor]:
    """The first n worker processes, started (spawn) where missing. Each
    is a one-process executor, so its tasks run in the order sent."""
    with _WORKERS_LOCK:
        ctx = multiprocessing.get_context("spawn")
        while len(_WORKERS) < n:
            _WORKERS.append(ProcessPoolExecutor(1, mp_context=ctx))
        return _WORKERS[:n]


def start_workers(n: int) -> None:
    """Starts the first n worker processes now and waits until each runs
    (each spawn imports the parent's main module and torch, seconds)."""
    for f in [w.submit(os.getpid) for w in workers(n)]:
        f.result()


def shutdown_workers() -> None:
    """Stop every worker process (they start again on demand)."""
    with _WORKERS_LOCK:
        for w in _WORKERS:
            w.shutdown(wait=True, cancel_futures=True)
        _WORKERS.clear()


atexit.register(shutdown_workers)


def _gather(items) -> Dict:
    """The batch of the workers' items: read from shared memory, collated,
    the blocks freed (also those of the other items when one failed)."""
    samples, error = [], None
    for f in items:
        try:
            samples.append(f.result())
        except Exception as e:  # raised below, after the others are freed
            error = error or e
    if error is not None:
        for sample in samples:
            _free_shared(sample)
        raise error
    return _collate_shared(samples)


class _Items:
    """Where a provider builds its batches: load_batch(ids, params)
    returns a future of the collated batch and the item futures it waits
    for. With worker processes, the parent's share (reading the items out
    of shared memory, collating, freeing) runs on a thread beside the
    caller: numpy's copies and the unmapping release the GIL, so it
    overlaps the caller's train step."""

    def __init__(self, dataset, num_workers: int, processes: bool):
        self.dataset = dataset
        self.token = None
        if processes:
            self.procs = workers(num_workers)
            self.token = f"{os.getpid()}-{next(_TOKENS)}"
            payload = pickle.dumps(dataset, pickle.HIGHEST_PROTOCOL)
            for w in self.procs:
                w.submit(_worker_set, self.token, payload)
        self.pool = ThreadPoolExecutor(
            max_workers=1 if processes else max(1, num_workers))

    def load_batch(self, ids, params):
        if self.token is None:
            ds = self.dataset
            fetch = ds.load if hasattr(ds, "draw") else (lambda i, p: ds[i])
            return self.pool.submit(lambda: collate(
                [fetch(i, p) for i, p in zip(ids, params)])), []
        items = [self.procs[i % len(self.procs)].submit(
            _worker_load, self.token, i, p) for i, p in zip(ids, params)]
        return self.pool.submit(_gather, items), items

    def discard(self, batch) -> None:
        """Drops a batch built but never taken, freeing its shared
        blocks."""
        fut, items = batch
        if fut.cancel():
            for f in items:
                if not f.cancel():
                    try:
                        _free_shared(f.result())
                    except Exception:  # the item failed: it left nothing
                        pass
            return
        try:
            fut.result()  # collated, so freed
        except Exception:  # an item failed; _gather freed the rest
            pass

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=self.token is None)
        if self.token is None:
            return
        for w in self.procs:
            try:
                w.submit(_worker_drop, self.token)
            except RuntimeError:  # the workers were shut down already
                pass


class DataProvider:
    """Infinite (or single-epoch) iterator of collated numpy batches.
    processes: build the items in worker processes; by default when the
    dataset reads files and num_workers >= 2.

    split, under data parallelism (parallel/mesh.py): every rank walks the
    same index order and draws every item's transform parameters, then
    with "rows" builds only its rows of each batch of batch_size (the
    global batch; training), with "batches" only the batches i with
    i % world == rank (evaluation). None: every rank gets every batch
    (pool scoring, whose rows the trainer splits)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, infinite: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 processes: Optional[bool] = None,
                 split: Optional[str] = None):
        if split not in (None, "rows", "batches"):
            raise ValueError(f"split {split!r}: None, 'rows' or 'batches'")
        self.split = split
        self.rank, self.world = mesh.rank(), mesh.world()
        if split == "rows":
            mesh.local_rows(batch_size)  # raises unless world divides it
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.infinite = infinite
        self.rng = np.random.RandomState(seed)
        if processes is None:
            processes = (getattr(dataset, "reads_files", False)
                         and num_workers >= 2)
        self.prefetch = PREFETCH
        if processes:  # enough items in flight to keep every worker busy
            self.prefetch = max(PREFETCH, -(-2 * num_workers // batch_size))
        self.items = _Items(dataset, num_workers, processes)
        self._iter = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            n = n // self.batch_size
        else:
            n = (n + self.batch_size - 1) // self.batch_size
        if self.split == "batches":
            return (n - self.rank + self.world - 1) // self.world
        return n

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
        counter = itertools.count()
        draw = getattr(self.dataset, "draw", lambda i: None)

        def submit_next():
            while True:
                try:
                    ids = [int(i) for i in next(batches)]
                except StopIteration:
                    return False
                params = [draw(i) for i in ids]
                k = next(counter)
                if self.split == "batches" and \
                        k % self.world != self.rank:
                    continue
                if self.split == "rows":
                    rows = mesh.local_rows(len(ids), self.rank, self.world)
                    ids, params = ids[rows], params[rows]
                pending.put(self.items.load_batch(ids, params))
                return True

        alive = True
        try:
            for _ in range(self.prefetch):
                alive = submit_next() and alive
            while not pending.empty():
                fut, _ = pending.get()
                yield fut.result()
                if alive:
                    alive = submit_next()
        finally:  # closed early: drop what is still in flight
            while not pending.empty():
                self.items.discard(pending.get())

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
        """Stop the worker threads, or free the dataset in the worker
        processes (the iterator must not be used after)."""
        if self._iter is not None:
            self._iter.close()
        self.items.close()
