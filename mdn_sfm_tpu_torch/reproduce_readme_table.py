"""Reproduce the reference README metric table in one command, with the
port's ``evaluate_mix``.

Given KITTI data and the reference's trained checkpoints (the ``.pth`` files
the original repo ships under ``log/{version}/models/weights_{idx}/``, which
the port's loader reads as they are), this runs ``evaluate_mix`` for every
mode at its published binarization threshold and prints measured against
published rows.

    python -m mdn_sfm_tpu_torch.reproduce_readme_table \\
        --data_root kitti \\
        --log_dir log \\
        --gt_mask_path output/mobile_objects_ground_truth \\
        --frozen_folder log/v0/models/weights_0 \\
        --mode_versions SN=v1:14 T=v2:14 TG=v3:14 DS=v4:14 DC=v5:14 \\
        --sweep 0.02

``--mode_versions`` maps each mode to the ``version:idx`` checkpoint trained
in that mode; modes without a mapping are skipped. ``--sweep`` also scores
the thresholds published±sweep in the same pass and reports the best-Dice
operating point: upsampling the prediction to GT resolution before
binarizing can shift the published thresholds by ±0.02 (PARITY.md). Runs on
``cuda`` unless ``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

from .config import Config, Mode
from .evaluate_mix import evaluate

# the reference README's table: (accuracy, precision, recall, dice, binary threshold)
PUBLISHED = {
    "SN": (85.68, 19.15, 32.64, 18.58, 0.18),
    "T": (80.70, 10.53, 27.20, 11.48, 0.32),
    "TG": (92.34, 22.95, 27.86, 21.17, 0.30),
    "DS": (95.89, 56.32, 52.97, 49.98, 0.48),
    "DC": (83.54, 25.00, 61.63, 28.71, 0.15),
}


def main(argv: Sequence[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default="kitti")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--gt_mask_path", default="output/mobile_objects_ground_truth")
    p.add_argument("--frozen_folder", default="log/v0/models/weights_0")
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--width", type=int, default=416)
    p.add_argument("--mode_versions", nargs="+", default=[],
                   help="MODE=version:idx per trained checkpoint, e.g. SN=v1:14")
    p.add_argument("--eval_num_samples", type=int, default=200)
    p.add_argument("--eval_out_dir", default="output")
    p.add_argument("--sweep", type=float, default=0.0,
                   help="also score thresholds published±sweep (step --sweep_step) in the same pass "
                        "and report the best-Dice operating point")
    p.add_argument("--sweep_step", type=float, default=0.01)
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    args = p.parse_args(argv)

    mapping = {}
    for spec in args.mode_versions:
        mode, vi = spec.split("=")
        version, idx = vi.split(":")
        mapping[mode.upper()] = (version, int(idx))
    if not mapping:
        p.error("--mode_versions is required (no trained checkpoints specified)")

    rows = []
    for mode_name, (version, idx) in mapping.items():
        pub = PUBLISHED[mode_name]
        cfg = Config(
            data_root=args.data_root, log_dir=args.log_dir, gt_mask_path=args.gt_mask_path,
            load_weights_folder=args.frozen_folder, height=args.height, width=args.width,
            mode=Mode(mode_name), version=version, idx=idx, binary_threshold=pub[4],
            eval_num_samples=args.eval_num_samples, eval_out_dir=args.eval_out_dir,
        ).validate()
        cfg = dataclasses.replace(cfg, w_d2_sim=0.05 if mode_name == "DC" else 0.0)
        print(f"\n=== mode {mode_name} (threshold {pub[4]}) ===")
        if args.sweep > 0:
            n = round(args.sweep / args.sweep_step)
            thresholds = [round(pub[4] + i * args.sweep_step, 4) for i in range(-n, n + 1)
                          if 0.0 < pub[4] + i * args.sweep_step < 1.0]
            result, sweep_rows = evaluate(cfg, thresholds=thresholds, device=args.device)
            best_t = max(sweep_rows, key=lambda t: sweep_rows[t][0][4])
            rows.append((mode_name, result[0], pub, (best_t, sweep_rows[best_t][0])))
        else:
            rows.append((mode_name, evaluate(cfg, device=args.device)[0], pub, None))

    print("\n| Mode | Acc (pub) | Prec (pub) | Recall (pub) | Dice (pub) |")
    print("|------|-----------|------------|--------------|------------|")
    for mode_name, r, pub, _ in rows:
        print(f"| {mode_name} | {100 * r[0]:.2f} ({pub[0]}) | {100 * r[1]:.2f} ({pub[1]}) "
              f"| {100 * r[2]:.2f} ({pub[2]}) | {100 * r[4]:.2f} ({pub[3]}) |")
    if any(best for *_, best in rows):
        print(f"\nBest-Dice operating point within the sweep (published threshold ±{args.sweep}):")
        print("| Mode | best thr (pub thr) | Dice@best (pub) |")
        print("|------|--------------------|-----------------|")
        for mode_name, _, pub, best in rows:
            if best is not None:
                t, br = best
                print(f"| {mode_name} | {t:.2f} ({pub[4]}) | {100 * br[4]:.2f} ({pub[3]}) |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
