"""Precompute DS/DC union masks for a training split with the 1024-edge
Mask R-CNN backend — the port of ``tools/precompute_masks.py``.

The live provider infers at ``d2_infer_scale ×`` the training resolution;
the reference runs detectron2 at shortest-edge 1024. This tool walks a split
manifest, runs :class:`~mdn_sfm_tpu_torch.masks.maskrcnn.MaskRCNNBackend`
over every target frame and writes ``{mask_dir}/{sample_key}.png`` (0/255,
mode L) under the Trainer's key scheme (``data/splits.py::sample_key``),
ready for

    python -m mdn_sfm_tpu_torch.train --mode DS --mask_provider precomputed \\
        --mask_dir <mask_dir> --disable_augment ...

(precomputed masks cannot follow the on-device flip and zoom-crop). Existing
files are skipped unless ``--overwrite``; ``--shard_index/--shard_count``
split a large split across machines. Runs on ``cuda`` unless ``--device``
names another device.

    python -m mdn_sfm_tpu_torch.precompute_masks --data_path kitti/raw_data \\
        --weights log/model_final_detectron2.pth [--split eigen_zhou] [--limit N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterable, Sequence

import numpy as np

from .data.kitti import SIDE_MAP
from .data.splits import read_split_lines, repo_root, sample_key, split_path


def manifest_items(data_path: str, lines, img_ext: str = ".jpg") -> list[tuple[str, str]]:
    """Deduplicated, sorted (sample key, target-frame path) pairs of a split
    manifest, under the key scheme the Trainer's mask lookups use."""
    seen: dict[str, str] = {}
    for ln in lines:
        key = sample_key(ln)
        if key not in seen:
            seen[key] = os.path.join(data_path, ln.folder, f"image_0{SIDE_MAP[ln.side]}/data",
                                     f"{ln.frame_index:010d}{img_ext}")
    return sorted(seen.items())


def precompute_masks(backend, items: Iterable[tuple[str, "str | np.ndarray"]], mask_dir: str,
                     overwrite: bool = False, log_every: int = 25, batch: int = 1) -> dict:
    """Run ``backend.predict_union_batch`` over ``items`` of (key, image path
    or RGB array), ``batch`` consecutive same-size images a forward, and write
    ``{mask_dir}/{key}.png``. Returns {"written", "skipped", "failed",
    "empty"}."""
    from PIL import Image

    os.makedirs(mask_dir, exist_ok=True)
    stats = {"written": 0, "skipped": 0, "failed": 0, "empty": 0}
    t0 = time.time()
    pending: list[tuple[str, np.ndarray, str]] = []

    def flush():
        if not pending:
            return
        unions = backend.predict_union_batch([p[1] for p in pending])
        for (_key, _img, out_path), union in zip(pending, unions):
            union = np.asarray(union, np.uint8)
            if not union.any():
                stats["empty"] += 1
            Image.fromarray(union * np.uint8(255), mode="L").save(out_path)
            stats["written"] += 1
            if log_every and stats["written"] % log_every == 0:
                rate = stats["written"] / max(time.time() - t0, 1e-9)
                print(f"written={stats['written']} ({rate:.2f} masks/s)", file=sys.stderr, flush=True)
        pending.clear()

    for key, src in items:
        out_path = os.path.join(mask_dir, f"{key}.png")
        if not overwrite and os.path.exists(out_path):
            stats["skipped"] += 1
            continue
        if isinstance(src, str):
            if not os.path.exists(src):
                print(f"MISSING image for {key}: {src}", file=sys.stderr)
                stats["failed"] += 1
                continue
            with Image.open(src) as im:
                img = np.asarray(im.convert("RGB"))
        else:
            img = np.asarray(src)
        if pending and (len(pending) >= max(batch, 1) or pending[0][1].shape != img.shape):
            flush()
        pending.append((key, img, out_path))
    flush()
    return stats


def main(argv: Sequence[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_path", required=True, help="KITTI raw root")
    p.add_argument("--split", default="eigen_zhou", help="split name under splits/ (or an absolute split dir)")
    p.add_argument("--subset", default="train", choices=["train", "val"])
    p.add_argument("--mask_dir", default="output/prediction/detectron2/pred_masks",
                   help="output dir — must match the training run's --mask_dir")
    p.add_argument("--weights", default="", help="detectron2 .pth (model_final_detectron2.pth)")
    p.add_argument("--allow_random_weights", action="store_true",
                   help="proceed without weights (RANDOM masks — tests only)")
    p.add_argument("--img_ext", default=".jpg", help=".jpg or .png raw frames")
    p.add_argument("--limit", type=int, default=0, help="stop after N keys")
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1,
                   help="process keys [shard_index::shard_count] (the output files are disjoint)")
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--batch", type=int, default=8, help="same-size images per forward")
    p.add_argument("--max_det", type=int, default=32)
    p.add_argument("--score_thresh", type=float, default=0.3,
                   help="detectron2's ROI_HEADS.SCORE_THRESH_TEST of the reference")
    p.add_argument("--input_hw", default="",
                   help="static backend input 'H,W' (default: the 1024-edge KITTI shape 640,2048). "
                        "The JAX tool's --spatial_shards (a TPU mesh over the image width) has no "
                        "counterpart here: one card runs the whole image")
    p.add_argument("--device", default="cuda", help="default: cuda")
    args = p.parse_args(argv)

    if not args.weights and not args.allow_random_weights:
        raise SystemExit("refusing to precompute DS/DC supervision masks with RANDOM Mask R-CNN weights — "
                         "pass --weights model_final_detectron2.pth (or --allow_random_weights for tests)")
    lines = read_split_lines(split_path(repo_root(), args.split, args.subset))
    items = manifest_items(args.data_path, lines, args.img_ext)[args.shard_index::args.shard_count]
    if args.limit:
        items = items[: args.limit]
    print(f"{len(items)} unique target frames to mask (shard {args.shard_index}/{args.shard_count})",
          file=sys.stderr)

    from .masks.maskrcnn import MaskRCNNBackend

    input_hw = tuple(int(v) for v in args.input_hw.split(",")) if args.input_hw else None
    backend = MaskRCNNBackend(weights_path=args.weights or None, max_det=args.max_det,
                              score_thresh=args.score_thresh, input_hw=input_hw, device=args.device)
    stats = precompute_masks(backend, items, args.mask_dir, overwrite=args.overwrite, batch=args.batch)
    print(json.dumps({"mask_dir": args.mask_dir, **stats}))
    return stats


if __name__ == "__main__":
    main()
