"""Train entry point of the port, with the flags of the JAX package's
``train.py``:

    python -m mdn_sfm_tpu_torch.train --data_path kitti/raw_data --v_save v1
    python -m mdn_sfm_tpu_torch.train --synthetic          # no KITTI needed
    python -m mdn_sfm_tpu_torch.train --epipolar_statics   # the --threshold calibration
    python -m mdn_sfm_tpu_torch.train --hyper w_d2_sim --hyper_values 0.01 0.05 0.1
    python -m mdn_sfm_tpu_torch.train --synthetic --device cpu --height 64 --width 96

Runs on the card unless ``--device`` names another device; without CUDA
and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
from typing import Sequence

from .config import add_train_args, from_args
from .trainer import Trainer


def main(argv: Sequence[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="MDN-SfM PyTorch train")
    add_train_args(parser)
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (no KITTI needed)")
    parser.add_argument("--epipolar_statics", action="store_true",
                        help="compute the epipolar percentile thresholds instead of training")
    parser.add_argument("--hyper", type=str, default="",
                        help="hyperparameter grid search over this config field")
    parser.add_argument("--hyper_values", nargs="+", type=float, default=[])
    parser.add_argument("--debug_nans", action="store_true",
                        help="autograd anomaly mode: every backward op checks for NaN")
    parser.add_argument("--device", type=str, default="cuda", help="default: cuda")
    args = parser.parse_args(argv)
    cfg = from_args(args)

    trainer = Trainer(cfg, synthetic=args.synthetic, debug_nans=args.debug_nans, device=args.device)
    if args.epipolar_statics:
        print("Thresholds are :", trainer.epipolar_statics())
    elif args.hyper:
        print(trainer.hyperparameter_try(args.hyper, args.hyper_values))
    else:
        trainer.train()


if __name__ == "__main__":
    main()
