"""Eval-CLI throughput bench: evaluate_mix samples/s at a given
``--eval_batch_size`` on a synthetic KITTI-2015 world — the port of
``tools/bench_eval.py``.

The reference evaluates one sample at a time with dozens of eager ops a
sample; the port's evaluate_mix runs ``eval_batch_size`` samples through one
forward and one epipolar launch, so the batch size sets how many launches and
host syncs a sample costs. Random weights in the reference ``.pth`` layout;
one warm-up call, then one timed call. Runs on ``cuda`` unless ``--device``
names another device. A/B with:

    python -m mdn_sfm_tpu_torch.bench_eval --n 32 --eval_batch_size 1
    python -m mdn_sfm_tpu_torch.bench_eval --n 32 --eval_batch_size 8
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Sequence

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--eval_batch_size", type=int, default=8)
    ap.add_argument("--device", type=str, default="cuda", help="default: cuda")
    return ap


def main(argv: Sequence[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from . import checkpoints as ckpt
    from . import evaluate_mix
    from . import training as T
    from .config import Config
    from .data.worlds import make_gt_masks, make_kitti2015
    from .utils import resolve_device

    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="mdn_bench_eval_") as tmp:
        root = os.path.join(tmp, "kitti")
        gt_dir = os.path.join(tmp, "gt")
        log_dir = os.path.join(tmp, "log")
        make_kitti2015(root, n=args.n, h=args.height, w=args.width)
        make_gt_masks(gt_dir, n=args.n, h=args.height, w=args.width)

        cfg = Config(
            height=args.height, width=args.width, data_root=root, log_dir=log_dir,
            gt_mask_path=gt_dir, eval_out_dir=os.path.join(tmp, "out"),
            eval_num_samples=args.n, eval_batch_size=args.eval_batch_size,
            load_weights_folder=ckpt.weights_folder(log_dir, "v0", 0),
            version="v1", idx=0, w_d2_sim=0.0,
        ).validate()

        # random checkpoints in the reference layout (throughput only)
        nets = T.modules_by_name(T.build_models(cfg, torch.Generator().manual_seed(0), "cpu"))
        sd = {k: ckpt.to_host(m.state_dict()) for k, m in nets.items()}
        ckpt.save_checkpoint(cfg.load_weights_folder, {k: sd[k] for k in ("flownet", "posenet")})
        ckpt.save_checkpoint(ckpt.weights_folder(log_dir, "v1", 0), {"mobile_decoder": sd["mobile_decoder"]})

        result = evaluate_mix.evaluate(cfg, device=device)  # warm-up (cuDNN plans, the kernel's build)
        assert np.all(np.isfinite(result)), result
        t0 = time.perf_counter()
        evaluate_mix.evaluate(cfg, device=device)
        dt = time.perf_counter() - t0
    print(f"evaluate_mix: {args.n} samples in {dt:.1f}s (warm) = "
          f"{args.n / dt:.2f} samples/s at eval_batch_size={args.eval_batch_size}")
    return {"n": args.n, "eval_batch_size": args.eval_batch_size, "seconds": dt, "samples_per_s": args.n / dt,
            "device": device.type}


if __name__ == "__main__":
    main()
