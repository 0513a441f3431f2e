"""Threaded host input pipeline — the port's own copy of
``mdn_sfm_tpu.data.loader``.

Decode threads fill a bounded window of batches ahead of the consumer. The
per-epoch shuffle is ``numpy.random.default_rng(seed + epoch)``, so the batch
order equals the JAX loader's for the same seed, epoch and skip.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator

import numpy as np


class Subset:
    """Index-selected view of a map-style dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


class HostLoader:
    """Shuffling, batching, prefetching loader over a map-style dataset.

    Iterating yields ``(arrays, indices)``: the stacked item arrays and the
    dataset indices of the batch.

    Args:
        dataset: object with __len__ and __getitem__ → tuple of np arrays.
        batch_size: the host's batch size.
        shuffle: reshuffle each epoch with ``default_rng(seed + epoch)``.
        seed: base seed.
        num_workers: decode threads.
        drop_last: drop the trailing partial batch.
        prefetch: batches decoded ahead beyond one per worker.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 42,
                 num_workers: int = 4, drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator:
        return self.iter_batches(0)

    def iter_batches(self, skip: int = 0) -> Iterator:
        """Iterate the epoch, dropping the first ``skip`` batches without
        decoding them (exact mid-epoch resume). The order depends only on
        (seed, epoch), so a process that sets ``loader.epoch`` to the
        interrupted epoch sees the same sequence."""
        indices = self._epoch_indices()
        self.epoch += 1
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size] for i in range(skip, len(self))]
        nb = len(batches)

        job_q: queue.Queue = queue.Queue()
        results: dict[int, object] = {}
        lock = threading.Lock()
        stop = threading.Event()
        consumed = [0]  # consumer position, guarded by lock
        for job in enumerate(batches):
            job_q.put(job)
        window = self.prefetch + self.num_workers

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = job_q.get_nowait()
                except queue.Empty:
                    return
                # stay within the window ahead of the consumer, so a consumer
                # that stops early does not leave threads decoding the epoch
                while not stop.is_set():
                    with lock:
                        if bi - consumed[0] < window:
                            break
                    time.sleep(0.002)
                if stop.is_set():
                    return
                try:
                    items = [self.dataset[int(i)] for i in idxs]
                    out = (tuple(np.stack([it[k] for it in items]) for k in range(len(items[0]))), idxs)
                except Exception as e:  # raised to the consumer at this batch
                    out = e
                with lock:
                    results[bi] = out

        for t in [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]:
            t.start()
        try:
            for bi in range(nb):  # in order, as they complete
                while True:
                    with lock:
                        if bi in results:
                            out = results.pop(bi)
                            consumed[0] = bi + 1
                            break
                    time.sleep(0.001)
                if isinstance(out, Exception):
                    raise out
                yield out
        finally:
            stop.set()  # generator closed early: stop the decode threads
