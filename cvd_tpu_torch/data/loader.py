"""Host-side data loading: prefetching worker threads over a seeded
per-epoch permutation (port of ``cvd_tpu/data/loader.py``, one process,
thread workers only).

A thread pool maps ``__getitem__`` while the card steps; two batches are
kept ready. Not ported yet (ROADMAP queue 1, training): forked decode
workers (``worker_type="process"``) and the per-process index shard that
multi-GPU training needs.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

PREFETCH = 2  # batches kept ready ahead of the consumer


def _qput(q, item, stop) -> bool:
    """put that re-checks ``stop``: a consumer that abandoned iteration
    leaves the queue full, and a plain put would block the producer."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.25)
            return True
        except queue.Full:
            continue
    return False


def epoch_batches(n: int, epoch: int, seed: int, batch_size: int) -> np.ndarray:
    """The epoch's seeded permutation of ``range(n)`` as [steps, batch_size]
    (the last partial batch dropped)."""
    idx = np.random.default_rng(seed + epoch).permutation(n)
    steps = n // batch_size
    return idx[: steps * batch_size].reshape(steps, batch_size)


def _stack_batch(samples: Sequence[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = list(vals) if isinstance(vals[0], str) else np.stack(
            [np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Batched iterator with background prefetch over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 8,
                 worker_type: str = "thread"):
        if worker_type == "process":
            raise NotImplementedError("worker_type='process' is not ported yet (ROADMAP "
                                      "queue 1, training: process workers)")
        if worker_type != "thread":
            raise ValueError(f"worker_type {worker_type!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        batches = epoch_batches(len(self.dataset), self.epoch, self.seed, self.batch_size)
        self.epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        if not _qput(q, _stack_batch(samples), stop):
                            return
                _qput(q, None, stop)
            except Exception as e:  # noqa: BLE001 - re-raised in the consumer
                _qput(q, e, stop)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            thread.join()
