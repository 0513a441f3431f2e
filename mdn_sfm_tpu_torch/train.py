"""Train entry point of the port (minimal): N steps on synthetic data.

    python -m mdn_sfm_tpu_torch.train --synthetic --num_steps 50 --mode TG \\
        --height 192 --width 640 --threshold 9.22 --w_d2_sim 0

Runs on the card (``--device cpu`` to run on the CPU) with random weights,
and prints ``epoch 0 | batch N | loss: …`` lines. Checkpoints, TensorBoard,
validation and KITTI loading come with the full trainer.
"""

from __future__ import annotations

import argparse
import time
from typing import Sequence

import torch

from . import training as T
from .config import add_train_args, from_args
from .data.synthetic import synthetic_batch
from .utils import resolve_device


def main(argv: Sequence[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="MDN-SfM PyTorch train (synthetic data)")
    add_train_args(parser)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (the only source this slice has)")
    parser.add_argument("--num_steps", type=int, default=10)
    parser.add_argument("--device", type=str, default=None, help="default: cuda")
    args = parser.parse_args(argv)
    if not args.synthetic:
        parser.error("only --synthetic training is implemented by the PyTorch port yet")
    cfg = from_args(args)
    device = resolve_device(args.device)

    gen = torch.Generator().manual_seed(cfg.seed)
    models = T.build_models(cfg, gen, device)
    opt = T.make_optimizer(cfg, models, steps_per_epoch=args.num_steps)
    aug_gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)

    for step in range(args.num_steps):
        colors, K = synthetic_batch(cfg.batch_size, cfg.height, cfg.width,
                                    len(cfg.frame_ids), seed=step)
        batch = {"colors_u8": torch.from_numpy(colors).to(device),
                 "K": torch.from_numpy(K).to(device)}
        t0 = time.perf_counter()
        metrics = T.train_step(cfg, models, opt, batch, generator=aug_gen)
        loss = float(metrics["loss"])  # syncs
        dt = time.perf_counter() - t0
        if step % max(cfg.log_frequency, 1) == 0 or step == args.num_steps - 1:
            print(f"epoch 0 | batch {step:>6} | loss: {loss:.5f} | "
                  f"examples/s: {cfg.batch_size / max(dt, 1e-9):5.1f}", flush=True)


if __name__ == "__main__":
    main()
