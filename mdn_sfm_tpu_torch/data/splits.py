"""Split manifests — the port's own copy of ``mdn_sfm_tpu.data.splits``.

Manifest lines are ``"<drive_dir> <frame_idx> <l|r>"`` (eigen_zhou: 39,810
train / 4,424 val lines, vendored gzip-compressed under ``splits/``).
"""

from __future__ import annotations

import gzip
import os
from typing import NamedTuple


class SplitLine(NamedTuple):
    folder: str
    frame_index: int
    side: str  # 'l' | 'r'

    @classmethod
    def parse(cls, line: str) -> "SplitLine":
        parts = line.split()
        folder = parts[0]
        frame_index = int(parts[1]) if len(parts) >= 2 else 0
        side = parts[2] if len(parts) >= 3 else "l"
        return cls(folder, frame_index, side)


# manifest side tokens: eigen_zhou uses l/r; KITTI camera ids 2/3 are
# accepted aliases (data/kitti.py::SIDE_MAP), canonicalized so aliased
# manifests resolve to the same key
_CANONICAL_SIDE = {"l": "l", "2": "l", "r": "r", "3": "r"}


def sample_key(line: SplitLine) -> str:
    """Canonical per-sample key of the mask lookups:
    ``{folder with / -> _}_{frame_index}_{canonical side l|r}``. The side is
    part of the key (the two cameras see different scenes), and '2' ≡ 'l',
    '3' ≡ 'r'."""
    side = _CANONICAL_SIDE.get(line.side, line.side)
    return f"{line.folder.replace('/', '_')}_{line.frame_index}_{side}"


def repo_root() -> str:
    """The checkout's root, which holds ``splits/``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def split_path(repo_root: str, split: str, subset: str) -> str:
    """Path to ``splits/<split>/<subset>_files.txt``, or its ``.gz`` when the
    plain file is absent. ``split`` may also be an absolute directory that
    holds the manifest files."""
    base = split if os.path.isabs(split) else os.path.join(repo_root, "splits", split)
    plain = os.path.join(base, f"{subset}_files.txt")
    return plain if os.path.exists(plain) else plain + ".gz"


def read_split_lines(path: str) -> list[SplitLine]:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            text = f.read()
    else:
        with open(path) as f:
            text = f.read()
    return [SplitLine.parse(ln) for ln in text.splitlines() if ln.strip()]


def shard_for_host(lines: list, host_id: int | None = None, host_count: int | None = None) -> list:
    """Static per-process shard of the manifest, strided so drives
    interleave; ``host_id`` and ``host_count`` default to the process
    group's rank and size (0 and 1 without a group).

    Every shard is cut to the common length ``len(lines) // host_count``, so
    all processes run the same number of steps an epoch: a process with one
    more step would enter an all-reduce the others never reach."""
    if host_id is None:
        from ..parallel import process_count, process_index

        host_id, host_count = process_index(), process_count()
    per_host = len(lines) // host_count
    return lines[host_id::host_count][:per_host]
