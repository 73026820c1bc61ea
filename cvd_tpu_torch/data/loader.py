"""Host-side data loading: prefetching workers over a seeded per-epoch
permutation, sharded by process (port of ``cvd_tpu/data/loader.py``).

A worker pool maps ``__getitem__`` while the card steps; two batches are
kept ready (``DataLoader.stats`` counts the draws, the batches ready at
each, the consumer's wait and the workers' busy time). Each process of a
multi-process run takes a strided slice of the epoch's permutation
(``shard_indices``, the DistributedSampler of train_epi_control.py:289-306).

Two worker types:
  * ``thread``: a thread pool. Frame decode holds the interpreter lock for
    much of its time, so this tops out near one core.
  * ``process``: worker processes forked at the start of each epoch (the
    reference's num_workers=32), each decoding on its own core; samples come
    back pickled. The fork happens after the model is on the card and
    torch's CPU thread pool is up, so a dataset's ``__getitem__`` must stay
    numpy / PIL: a child that touched CUDA or torch's thread pool could
    deadlock on state it inherited. The children call no torch at all.
"""
from __future__ import annotations

import functools
import queue
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np

PREFETCH = 2  # batches kept ready ahead of the consumer

# The dataset a process pool's workers inherit through fork (initargs would
# pickle it). Valid only between "assign" and "fork done", so both happen
# under _FORK_LOCK: loaders iterated side by side (hybrid training) must not
# fork while another loader's dataset is staged.
_FORK_DATASET = None
_FORK_LOCK = threading.Lock()


def _qput(q, item, stop) -> bool:
    """put that re-checks ``stop``: a consumer that abandoned iteration
    leaves the queue full, and a plain put would block the producer (and its
    worker pool) forever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.25)
            return True
        except queue.Full:
            continue
    return False


def _process_worker_init(seed: int, counter) -> None:
    """Reseed the forked worker's streams (the dataset's ``random.Random``
    and numpy's global one) with ``seed * 1000 + worker id``, the id from a
    shared counter, so that workers do not replay one stream and a run is
    reproducible."""
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    wseed = seed * 1000 + wid
    rng = getattr(_FORK_DATASET, "rng", None)
    if isinstance(rng, random.Random):
        rng.seed(wseed)
    np.random.seed(wseed % 2 ** 32)


def _timed(get, i) -> tuple:
    """(get(i), the seconds it took)."""
    t0 = time.perf_counter()
    sample = get(i)
    return sample, time.perf_counter() - t0


def _process_worker_get(i: int) -> tuple:
    return _timed(_FORK_DATASET.__getitem__, int(i))


def shard_indices(n: int, epoch: int, seed: int = 0, process_index: int = 0,
                  process_count: int = 1, shuffle: bool = True,
                  drop_last_to_multiple: Optional[int] = None) -> np.ndarray:
    """This process's indices for the epoch: the seeded permutation of
    ``range(n)`` (``seed + epoch``; ``arange`` without ``shuffle``), every
    ``process_count``-th from ``process_index``, cut to a multiple of
    ``drop_last_to_multiple``."""
    idx = np.random.default_rng(seed + epoch).permutation(n) if shuffle else np.arange(n)
    idx = idx[process_index::process_count]
    if drop_last_to_multiple:
        idx = idx[: len(idx) // drop_last_to_multiple * drop_last_to_multiple]
    return idx


def _stack_batch(samples: Sequence[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = list(vals) if isinstance(vals[0], str) else np.stack(
            [np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Batched iterator with background prefetch over a map-style dataset.

    ``stats``, over the loader's life: ``draws`` (batches handed to the
    consumer), ``ready`` (the batches ready when it asked for each, summed:
    over ``draws`` the mean queue depth, 0 to ``PREFETCH``), ``wait_s``
    (the seconds it waited for them) and ``busy_s`` (the workers' seconds in
    ``__getitem__``, summed over the workers)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 8,
                 worker_type: str = "thread", process_index: int = 0, process_count: int = 1):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type {worker_type!r}: expected 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.worker_type = worker_type
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self.stats = dict(draws=0, ready=0, wait_s=0.0, busy_s=0.0)
        self._busy_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.dataset) // self.process_count // self.batch_size

    def _fork_pool(self):
        """This epoch's worker pool: the dataset staged and the workers
        forked under ``_FORK_LOCK``."""
        import multiprocessing

        global _FORK_DATASET
        ctx = multiprocessing.get_context("fork")
        counter = ctx.Value("i", 0)
        with _FORK_LOCK:
            _FORK_DATASET = self.dataset
            try:   # the workers fork (and capture the dataset) inside Pool()
                return ctx.Pool(self.num_workers, initializer=_process_worker_init,
                                initargs=(self.seed + self.epoch, counter))
            finally:
                _FORK_DATASET = None

    def _batch(self, timed) -> dict:
        """The batch of (sample, seconds) pairs; their seconds to ``busy_s``."""
        samples, seconds = zip(*timed)
        with self._busy_lock:   # an abandoned epoch's producer may still be mapping
            self.stats["busy_s"] += sum(seconds)
        return _stack_batch(samples)

    def _map_batches(self, batches, q, stop, pool) -> None:
        if pool is not None:
            for b in batches:
                if stop.is_set():
                    return
                batch = self._batch(pool.map(_process_worker_get, list(b)))
                if not _qput(q, batch, stop):
                    return
            return
        get = functools.partial(_timed, self.dataset.__getitem__)
        with ThreadPoolExecutor(self.num_workers) as tpool:
            for b in batches:
                if stop.is_set():
                    return
                if not _qput(q, self._batch(tpool.map(get, b)), stop):
                    return

    def __iter__(self) -> Iterator[dict]:
        idx = shard_indices(len(self.dataset), self.epoch, self.seed, self.process_index,
                            self.process_count, drop_last_to_multiple=self.batch_size)
        self.epoch += 1
        # forked here, in the consumer's thread, so that _FORK_LOCK orders it
        # with any other loader's fork; its workers reseed from seed + epoch + 1
        pool = self._fork_pool() if self.worker_type == "process" else None
        batches = idx.reshape(-1, self.batch_size)
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                self._map_batches(batches, q, stop, pool)
                _qput(q, None, stop)
            except Exception as e:  # noqa: BLE001 - re-raised in the consumer
                _qput(q, e, stop)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                ready = q.qsize()
                t0 = time.perf_counter()
                batch = q.get()
                waited = time.perf_counter() - t0
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                self.stats["draws"] += 1
                self.stats["ready"] += ready
                self.stats["wait_s"] += waited
                yield batch
        finally:
            stop.set()
            if pool is None:
                thread.join()
            else:
                # the workers go even when the consumer abandons the epoch; the
                # producer, a daemon, may be left waiting on a map they dropped
                pool.terminate()
                pool.join()
