"""Odometry evaluation on KITTI sequences 09/10 — the port of the root
``evaluate_pose.py``: the pose net on every pairwise step of each snippet,
chained into trajectories on the host in float64, scored by ATE/RE.

    python -m mdn_sfm_tpu_torch.evaluate_pose --raw_dataset_dir kitti --save_pred_poses
    python -m mdn_sfm_tpu_torch.evaluate_pose ... --device cpu

Every pairwise forward is independent, so one call of the pose net takes
``eval_batch_size·(sequence_length−1)`` pairs; only the chaining (a running
matrix product) stays on the host.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from . import training as T
from .config import Config, parse_eval_cli
from .data.eval_datasets import OdometryFramework, prepare_pair
from .metrics import compute_pose_error
from .utils import eval_chunks, resolve_device
from .viz import write_result


def evaluate(cfg: Config, device: str | torch.device | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Mean and std of [ATE, RE] over the snippets, on ``device`` (``cuda``
    unless asked otherwise); writes ``{eval_out_dir}/pose/result.txt`` and,
    with ``--save_pred_poses``, ``poses.npy`` (N, sequence_length, 3, 4)."""
    dev = resolve_device(device)
    models = T.load_eval_models(cfg, dev, nets=("posenet",))

    framework = OdometryFramework(os.path.join(cfg.raw_dataset_dir, "odometry_data"), ["09", "10"],
                                  cfg.sequence_length)
    print(f"-> Computing predictions with size {cfg.width}x{cfg.height}")
    print("-> Evaluating")

    n = len(framework)
    L = cfg.sequence_length
    predictions = np.zeros((n, L, 3, 4))
    errors = np.zeros((n, 2), np.float32)
    for idxs, n_valid in eval_chunks(n, cfg.eval_batch_size):
        samples = [framework[j] for j in idxs[:n_valid]]
        samples += [samples[-1]] * (len(idxs) - n_valid)
        pairs = [prepare_pair(s["imgs"][it], s["imgs"][it + 1], cfg.height, cfg.width)
                 for s in samples for it in range(L - 1)]
        tgt = torch.from_numpy(np.concatenate([t for t, _ in pairs])).to(dev)
        ref = torch.from_numpy(np.concatenate([r for _, r in pairs])).to(dev)
        pose_mats = T.eval_pose(cfg, models, tgt, ref).cpu().numpy().reshape(-1, L - 1, 4, 4)

        for bi in range(n_valid):
            j = idxs[bi]
            global_pose = np.eye(4)
            poses = [global_pose[:3, :].copy()]
            # chain: global ← global · inv(pairwise)
            for it in range(L - 1):
                global_pose = global_pose @ np.linalg.inv(pose_mats[bi, it])
                poses.append(global_pose[:3, :].copy())
            predictions[j] = np.stack(poses)
            errors[j] = compute_pose_error(samples[bi]["poses"], predictions[j])

    out_dir = os.path.join(cfg.eval_out_dir, "pose")
    os.makedirs(out_dir, exist_ok=True)
    if cfg.save_pred_poses:
        np.save(os.path.join(out_dir, "poses.npy"), predictions)
        print("-> Saving predicted poses to", out_dir)

    mean_errors, std_errors = errors.mean(0), errors.std(0)
    print("\nResults")
    print("\t {:>10}, {:>10}".format("ATE", "RE"))
    print("mean \t {:10.4f}, {:10.4f}".format(*mean_errors))
    print("std \t {:10.4f}, {:10.4f}".format(*std_errors))
    with open(os.path.join(out_dir, "result.txt"), "w") as f:
        write_result(f, mean_errors, ["ATE", "RE"])
    return mean_errors, std_errors


def main(argv: Sequence[str] | None = None) -> None:
    cfg, device = parse_eval_cli("MDN-SfM PyTorch evaluate_pose", argv)
    evaluate(cfg, device=device)


if __name__ == "__main__":
    main()
