"""Decoded-sample disk cache (``--cache_decoded DIR``) — the port's own copy
of ``mdn_sfm_tpu.data.cache``.

Augmentation runs on the card, so the host output for item ``i`` is a pure
function of (image bytes, height, width): the first epoch's decode work can
be kept. ``DecodedCache`` wraps a map-style dataset whose ``__getitem__``
returns a tuple of fixed-shape numpy arrays and memoizes each item into
per-column memory-mapped files.

Layout (under ``cache_dir/<fingerprint>/``):
    meta.json   — n items, per-column shapes/dtypes, the dataset cache key
    done.u8     — one byte per item (1 = columns written)
    col{k}.bin  — raw C-order item records, item i at offset i*itemsize

Safe under the loader's threads: writes land at disjoint per-item offsets
and the done flag is stored after the column data. A killed process leaves
half-written items only with their done byte 0, so they are recomputed.
``meta.json`` is written atomically and checked against the dataset on
reopen; a different split, size or column schema changes the fingerprint.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np


def _fingerprint(key: str, n: int, columns: list[dict]) -> str:
    blob = json.dumps({"key": key, "n": n, "columns": columns}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class DecodedCache:
    """Memmap-backed memoization of a map-style dataset.

    Args:
        dataset: object with ``__len__`` and ``__getitem__`` returning a
            tuple of numpy arrays with item-independent shapes/dtypes.
        cache_dir: root directory; the cache lives in a fingerprinted
            subdirectory so incompatible configurations never collide.
        key: identity of the dataset contents; defaults to
            ``dataset.cache_key()``.
    """

    def __init__(self, dataset, cache_dir: str, key: str | None = None):
        self.dataset = dataset
        if key is None:
            if not hasattr(dataset, "cache_key"):
                raise ValueError(
                    "DecodedCache needs an identity for the dataset contents: "
                    "pass key=... or give the dataset a cache_key() method"
                )
            key = dataset.cache_key()
        n = len(dataset)
        if n == 0:
            raise ValueError("refusing to cache an empty dataset")
        probe = dataset[0]
        self._columns = [{"shape": list(a.shape), "dtype": np.dtype(a.dtype).str} for a in probe]
        self.path = os.path.join(cache_dir, _fingerprint(key, n, self._columns))
        os.makedirs(self.path, exist_ok=True)

        meta_path = os.path.join(self.path, "meta.json")
        meta = {"n": n, "columns": self._columns, "key": key}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                on_disk = json.load(f)
            if on_disk != meta:  # fingerprint collision: never overwrite
                raise ValueError(
                    f"cache at {self.path} was built for a different dataset; "
                    "delete it or use another cache_dir"
                )
        else:
            fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, meta_path)

        self._n = n
        done_path = os.path.join(self.path, "done.u8")
        if not os.path.exists(done_path) or os.path.getsize(done_path) != n:
            self._preallocate(done_path, n)
        self._done = np.memmap(done_path, dtype=np.uint8, mode="r+", shape=(n,))
        self._cols = []
        for k, c in enumerate(self._columns):
            itemsize = int(np.prod(c["shape"])) * np.dtype(c["dtype"]).itemsize
            p = os.path.join(self.path, f"col{k}.bin")
            if not os.path.exists(p) or os.path.getsize(p) != n * itemsize:
                self._preallocate(p, n * itemsize)
            self._cols.append(np.memmap(p, dtype=c["dtype"], mode="r+", shape=(n, *c["shape"])))
        self._store(0, probe)  # the probe item is not decoded twice

    @staticmethod
    def _preallocate(path: str, nbytes: int) -> None:
        # sparse: full logical size at once, physical blocks as items land
        with open(path, "wb") as f:
            f.truncate(nbytes)

    def __len__(self) -> int:
        return self._n

    def _store(self, i: int, item) -> None:
        for col, arr in zip(self._cols, item):
            col[i] = arr
        self._done[i] = 1  # after the column writes (same thread)

    def __getitem__(self, i: int):
        if self._done[i]:
            # copies out of the memmap, so callers hold no pages of the file
            return tuple(np.array(col[i]) for col in self._cols)
        item = self.dataset[int(i)]
        self._store(i, item)
        return item

    @property
    def hit_fraction(self) -> float:
        """Fraction of items already cached."""
        return float(self._done.mean())

    def __getattr__(self, name):
        # pass the dataset's attributes through (e.g. the KITTI reader's .lines)
        if name == "dataset":  # not set yet during __init__
            raise AttributeError(name)
        return getattr(self.dataset, name)
