"""End-to-end sustained throughput of the real ``Trainer`` loop, input
included — the port of ``tools/bench_e2e.py``.

``profile_step`` and ``chip_smoke.py`` time the device step on synthetic
batches already in memory, and ``bench_loader`` times host decode alone.
This tool answers what the whole loop sustains when the input pipeline
(``HostLoader`` decoding full-resolution 375×1242 PNGs, resize, the copy to
the card, the K-step dispatch) has to keep the card fed. The reference hides
decode behind 12 DataLoader worker processes; here it is measured.

Protocol: write N synthetic full-resolution KITTI PNG triplets (the same
``make_raw_drive`` world as ``bench_loader``), point the real ``Trainer`` at
them through a temporary split manifest under the repository's ``splits/``
(where the Trainer reads splits; removed at the end), run one warm-up epoch
(the graph's capture, the caches), then time whole epochs until the window
is filled. The frames/s include decode, the copy to the card and dispatch.
Beside it: the same dataset's loader-only triplets/s in this process, and the
host cores it would take to feed the card at its compute-only rate
(``--compute_fps``). Runs on ``cuda`` unless ``--device`` names another
device.

    python -m mdn_sfm_tpu_torch.bench_e2e [--n_items 200] [--window 60] [--workers 4]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import tempfile
import time
from typing import Sequence

SPLIT_NAME = "_bench_e2e_tmp"
# the card's compute-only rate at the default shape: TG, 640×192, batch 4,
# K = 16 as one captured CUDA graph, 20.221 ms a step on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md §5)
H100_TG_K16_FPS = 197.8


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_items", type=int, default=200, help="synthetic full-resolution triplets on disk")
    p.add_argument("--window", type=float, default=60.0, help="timed window in seconds (whole epochs)")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--steps_per_dispatch", type=int, default=16)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--mode", default="TG")
    p.add_argument("--compute_fps", type=float, default=H100_TG_K16_FPS,
                   help="compute-only frames/s of the card at the same shape, for the implied-core figure "
                        "(default: TG at K = 16, 197.8 frames/s, 20.221 ms a step on an NVIDIA H100 80GB "
                        "HBM3 at 700 W; chip_smoke.py phase 10 measures it)")
    p.add_argument("--cache", action="store_true",
                   help="enable the decoded-sample disk cache (--cache_decoded); the warm-up epoch fills it, "
                        "the timed window measures the memmap read path")
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from .config import Config, Mode
    from .data.loader import HostLoader
    from .data.splits import repo_root, split_path
    from .data.worlds import make_raw_drive
    from .trainer import Trainer
    from .utils import resolve_device

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # after the last graph replay and the tail steps

    split_dir = os.path.join(repo_root(), "splits", SPLIT_NAME)
    data_root = tempfile.mkdtemp(prefix="mdn_bench_e2e_")
    log_dir = tempfile.mkdtemp(prefix="mdn_bench_e2e_log_")
    trainer = None
    try:
        print(f"writing {args.n_items} synthetic 375x1242 PNG triplets...", flush=True)
        lines = make_raw_drive(data_root, n_frames=args.n_items + 2, h=375, w=1242)
        os.makedirs(split_dir, exist_ok=True)
        with open(os.path.join(split_dir, "train_files.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if split_path(repo_root(), SPLIT_NAME, "train") != os.path.join(split_dir, "train_files.txt"):
            raise RuntimeError(f"the Trainer would not read the manifest written to {split_dir}")

        cfg = Config(
            data_path=data_root,
            data_root=data_root,  # no data_scene_flow inside: no val set
            log_dir=log_dir,
            split=SPLIT_NAME,
            height=args.height,
            width=args.width,
            batch_size=args.batch_size,
            mode=Mode[args.mode],
            steps_per_dispatch=args.steps_per_dispatch,
            num_workers=args.workers,
            num_epochs=10_000,          # epochs are driven by hand below
            save_frequency=10**9,       # no checkpoint inside the window
            log_frequency=10**9,
            v_save="bench_e2e",
            cache_decoded=os.path.join(data_root, "_cache") if args.cache else "",
        )
        trainer = Trainer(cfg, device=device)

        # loader-only throughput on the same dataset, in this process (the
        # loop below overlaps it with device work through the decode
        # threads; apart, it shows which side binds)
        loader = HostLoader(trainer.train_loader.dataset, args.batch_size, shuffle=False,
                            num_workers=args.workers, drop_last=True)
        next(iter(loader))  # warm the .so, the page cache
        t0 = time.perf_counter()
        n_rows = sum(a[0].shape[0] for (a, _i) in loader)
        loader_fps = n_rows / (time.perf_counter() - t0)
        print(f"loader-only: {loader_fps:.1f} triplets/s ({args.workers} worker threads, this host"
              f"{', cache cold fill' if args.cache else ''})", flush=True)
        if args.cache:
            # a second pass reads the warm memmap cache: the input rate the
            # timed epochs see
            t0 = time.perf_counter()
            n_rows = sum(a[0].shape[0] for (a, _i) in loader)
            loader_fps = n_rows / (time.perf_counter() - t0)
            print(f"loader-only (cache warm): {loader_fps:.1f} triplets/s", flush=True)

        # train()'s preamble by hand: the epoch loop without signal handlers,
        # the barrier or the final checkpoint
        trainer.epoch = 0
        trainer.step = trainer.start_step
        trainer.idx_save = trainer.start_idx_save
        trainer.start_time = time.time()
        trainer._skip_batches = 0

        print("warm-up epoch (capture + caches)...", flush=True)
        trainer.run_epoch()
        sync()

        print(f"timed window (>= {args.window:.0f}s of whole epochs)...", flush=True)
        step0 = trainer.step
        epochs = 0
        t0 = time.perf_counter()
        while True:
            trainer.epoch += 1
            trainer.run_epoch()
            sync()
            epochs += 1
            dt = time.perf_counter() - t0
            if dt >= args.window:
                break
        steps = trainer.step - step0
        e2e_fps = steps * args.batch_size / dt

        result = {
            "metric": "e2e_train_frames_per_s",
            "value": round(e2e_fps, 2),
            "unit": "frames/s",
            "loader_only_triplets_per_s": round(loader_fps, 2),
            "compute_only_frames_per_s": args.compute_fps,
            "implied_host_cores_to_feed_chip": math.ceil(args.compute_fps / max(loader_fps, 1e-9) * 10) / 10,
            "host_cores": os.cpu_count(),
            "steps": steps,
            "epochs": epochs,
            "window_s": round(dt, 2),
            "shape": f"{args.height}x{args.width} bs{args.batch_size} {args.mode} K={args.steps_per_dispatch}",
            "workers": args.workers,
            "cache": args.cache,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        }
        print(json.dumps(result))
        return result
    finally:
        if trainer is not None and trainer.writers:
            for w in trainer.writers.values():
                w.close()
        shutil.rmtree(split_dir, ignore_errors=True)
        shutil.rmtree(data_root, ignore_errors=True)
        shutil.rmtree(log_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
