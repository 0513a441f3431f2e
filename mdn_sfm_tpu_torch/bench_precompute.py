"""Throughput of the mask-precompute paths of the 1024-edge backend — the
port of ``tools/bench_precompute.py``.

Compares, at the 1024-edge input shape (640×2048) on synthetic 375×1242
street frames (random weights: the same compute graph):

  predict       one image a forward: the f32 padded input (15.7 MB) up,
                max_det full-resolution instance masks down [the GT-tooling API]
  union-batch   ``predict_union_batch``: ``--batch`` images a forward, the
                uint8 resized frame (3.8 MB) up, one union mask (0.47 MB) down
                an image [what ``precompute_masks`` uses]

Prints one JSON line {"n", "batch", "predict_s_per_img",
"union_batch_s_per_img", "speedup"}. Runs on ``cuda`` unless ``--device``
names another device.

    python -m mdn_sfm_tpu_torch.bench_precompute [--n 16] [--batch 8]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Sequence


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(backend, n: int, batch: int, scene_hw: tuple[int, int] = (375, 1242)) -> dict:
    """Time ``backend.predict`` a frame against ``predict_union_batch`` a
    batch, after one warm-up call of each, over ``n`` frames trimmed to a
    multiple of ``batch``. Raises ``ValueError`` when ``n < batch``: no whole
    batch is left to time."""
    from .data.worlds import make_street_scene

    if n < batch:
        raise ValueError(f"bench_precompute times whole batches: n={n} is less than batch={batch}")
    # trim to a batch multiple: a trailing partial batch would time another
    # shape than the others
    n -= n % batch
    imgs = [make_street_scene(*scene_hw, seed=i)[0] for i in range(n)]

    backend.predict(imgs[0])
    backend.predict_union_batch(imgs[:batch])
    _sync(backend.device)

    t0 = time.perf_counter()
    for im in imgs:
        backend.predict(im)
    _sync(backend.device)
    t_predict = (time.perf_counter() - t0) / n

    t0 = time.perf_counter()
    for i in range(0, n, batch):
        backend.predict_union_batch(imgs[i:i + batch])
    _sync(backend.device)
    t_union = (time.perf_counter() - t0) / n

    return {"n": n, "batch": batch, "predict_s_per_img": round(t_predict, 4),
            "union_batch_s_per_img": round(t_union, 4), "speedup": round(t_predict / t_union, 2)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max_det", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from .masks.maskrcnn import MaskRCNNBackend

    backend = MaskRCNNBackend(max_det=args.max_det, device=args.device)
    result = bench(backend, args.n, args.batch)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
