"""Host input-pipeline micro-bench: native C++ decode against the PIL + cv2
path — the port of ``tools/bench_loader.py``.

Writes a synthetic KITTI raw drive at full resolution (375×1242 PNG, the
KITTI raw frame size), then times triplet assembly through
``KittiRawDataset`` with ``use_native`` off and on, and the ``HostLoader``
triplets/s on top of each.

The reference hides this cost behind 12 DataLoader worker processes; here
the per-image decode is what bounds how fast the host can feed the card once
the device step is fast (``bench_e2e`` sets it beside the Trainer loop).
Host-only: nothing runs on a device. Where the native imgio library does not
build (no libjpeg/libpng headers), there is nothing to compare and it says so.

    python -m mdn_sfm_tpu_torch.bench_loader [n_items] [height] [width]
"""

from __future__ import annotations

import sys
import tempfile
import time
from typing import Sequence


def main(argv: Sequence[str] | None = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    n_items = int(argv[0]) if len(argv) > 0 else 24
    height = int(argv[1]) if len(argv) > 1 else 192
    width = int(argv[2]) if len(argv) > 2 else 640

    from . import native
    from .data.kitti import KittiRawDataset
    from .data.loader import HostLoader
    from .data.splits import SplitLine
    from .data.worlds import make_raw_drive

    if not native.imgio_available():
        print("native imgio unavailable (libjpeg/libpng missing) — nothing to compare")
        return {}

    results = {}
    with tempfile.TemporaryDirectory() as root:
        lines = [SplitLine.parse(s) for s in make_raw_drive(root, n_frames=n_items + 2, h=375, w=1242)]
        print(f"{len(lines)} triplets of 375×1242 PNG → {height}×{width}")

        for use_native, label in [(False, "PIL+cv2"), (True, "native C++")]:
            ds = KittiRawDataset(root, lines, height, width, use_native=use_native)
            ds[0]  # touch (the .so build, the PIL imports, the page cache)
            t0 = time.perf_counter()
            for i in range(len(lines)):
                ds[i]
            per = (time.perf_counter() - t0) / len(lines)
            print(f"  {label:>10} __getitem__: {per * 1e3:7.1f} ms/triplet "
                  f"({3 / per:6.1f} images/s, {1 / per:6.1f} triplets/s)")

            loader = HostLoader(ds, batch_size=4, shuffle=False, num_workers=4, drop_last=True, prefetch=2)
            t0 = time.perf_counter()
            nb = sum(1 for _ in loader)
            bs = 4 * nb / (time.perf_counter() - t0)
            print(f"  {label:>10} HostLoader(4 workers): {bs:6.1f} triplets/s")
            results[label] = {"ms_per_triplet": per * 1e3, "loader_triplets_per_s": bs, "batches": nb}
    return results


if __name__ == "__main__":
    main()
