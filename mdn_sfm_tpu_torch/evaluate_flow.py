"""Flow evaluation — the port of the root ``evaluate_flow.py``: predicted and
GT epipolar maps, flow EPE (occ/noc) at the original resolution, and flow /
error panels.

    python -m mdn_sfm_tpu_torch.evaluate_flow --raw_dataset_dir kitti --pred_errors
    python -m mdn_sfm_tpu_torch.evaluate_flow ... --device cpu

Per batch of ``eval_batch_size`` KITTI-2015 pairs, on the device: the eval
forward, then ONE epipolar launch for both |residual| maps of the batch —
the predicted flow's (the networks' normalized flow, scaled to pixels in the
kernel) and the GT flow's (pixels, resized to net resolution) with the
stereo baseline as its pose — and their per-sample max-normalizations. Per
sample: the predicted flow resized back to the frame's resolution (with the
reference's swapped-axes resize fixed, as the JAX CLI does), EPE on the host,
and the six-panel PNG.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from . import training as T
from .config import Config, parse_eval_cli
from .data.eval_datasets import ValidationFlow, prepare_pair
from .data.kitti import _resize_u8
from .geometry import gauss_distance_weight, resize_linear, scale_factor
from .metrics import compute_epe
from .ops.epipolar import EpipolarMap, epipolar_abs_residual_maps
from .utils import eval_chunks, resolve_device
from .viz import flow_to_image, get_flow_error_image, imwrite, write_result

Tensor = torch.Tensor


def _nmax(x: Tensor) -> Tensor:
    """Per-sample max over every axis but the first, at least 1e-12."""
    return x.amax(dim=tuple(range(1, x.ndim)), keepdim=True).clamp_min(1e-12)


def flow_maps(
    cfg: Config, models: T.ModelBundle, tgt: Tensor, ref: Tensor, inv_K: Tensor, gt_small: Tensor,
    gt_transform: Tensor, gauss_w: Tensor,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The batched flow-eval step on a normalized (B, H, W, 3) pair, inverse
    intrinsics (B, 3, 3), the GT flow at net resolution in pixels (B, H, W,
    2), the GT transform (B, 3, 4) and the (H, W) gauss weight: (pixel flow
    (B, H, W, 2), |residual| / max, (|residual| / gauss)² / max, GT |residual|
    / max), the maps (B, H, W) float32."""
    flows, _, _, _, cam = T.eval_forward(cfg, models, tgt, ref)
    flow = flows[0].float()
    epip, gt_epip = epipolar_abs_residual_maps([
        EpipolarMap(flow, (float(cfg.width), float(cfg.height)), inv_K, cam[:, :3, :3], cam[:, :3, 3]),
        EpipolarMap(gt_small, (1.0, 1.0), inv_K, gt_transform[:, :3, :3], gt_transform[:, :3, 3]),
    ])
    post = (epip / gauss_w[None]) ** 2
    return (flow * scale_factor(cfg.height, cfg.width, flow.device), epip / _nmax(epip),
            post / _nmax(post), gt_epip / _nmax(gt_epip))


def _resized(x: np.ndarray | Tensor, shape: tuple[int, ...], device: torch.device) -> np.ndarray:
    """``resize_linear`` on ``device``, back as a writable float32 array."""
    x = torch.as_tensor(x).to(device)
    return resize_linear(x, shape).cpu().numpy()


def evaluate(cfg: Config, device: str | torch.device | None = None) -> np.ndarray | None:
    """Write ``result.txt`` (with ``--pred_errors``) and the panels (with
    ``--save_pred_motions``) under ``{eval_out_dir}/flow/{eval_name}``, on
    ``device`` (``cuda`` unless asked otherwise). Returns the mean [epe_all,
    epe_noc] with ``--pred_errors``, else None."""
    dev = resolve_device(device)
    models = T.load_eval_models(cfg, dev, nets=("flownet", "posenet"))
    out_dir = os.path.join(cfg.eval_out_dir, "flow", cfg.eval_name)
    os.makedirs(out_dir, exist_ok=True)

    H, W = cfg.height, cfg.width
    gauss_w = gauss_distance_weight(H, W, 1, cfg.gauss_sigma1, cfg.gauss_sigma2, dev)[0]
    framework = ValidationFlow(cfg.raw_dataset_dir, n=cfg.eval_num_samples)
    print(f"-> Computing predictions with size {W}x{H}")
    print("-> Evaluating\n   Mono evaluation - using median scaling")

    errors_full = []
    for idxs, n_valid in eval_chunks(len(framework), cfg.eval_batch_size):
        samples = [framework[j] for j in idxs[:n_valid]]
        samples += [samples[-1]] * (len(idxs) - n_valid)

        inv_Ks, gt_smalls, pairs, zooms = [], [], [], []
        for sample in samples:
            h, w = sample["tgt"].shape[:2]
            zoom_x, zoom_y = W / w, H / h
            zooms.append((zoom_x, zoom_y))
            intrinsics = sample["intrinsics"].copy()
            intrinsics[0] *= zoom_x
            intrinsics[1] *= zoom_y
            K = np.eye(4, dtype=np.float32)
            K[:3, :3] = intrinsics
            inv_Ks.append(np.linalg.inv(K)[:3, :3])
            # the GT flow resized to net resolution, its components rescaled
            gt_small = _resized(sample["gt_flow_occ"][..., :2].astype(np.float32), (H, W, 2), dev)
            gt_small[..., 0] *= zoom_x
            gt_small[..., 1] *= zoom_y
            gt_smalls.append(gt_small)
            pairs.append(prepare_pair(sample["tgt"], sample["next_tgt"], H, W))

        def on_device(arrays):
            return torch.from_numpy(np.stack(arrays)).to(dev)

        tgt = torch.from_numpy(np.concatenate([t for t, _ in pairs])).to(dev)
        ref = torch.from_numpy(np.concatenate([r for _, r in pairs])).to(dev)
        full_b, epipn_b, post_b, gtep_b = flow_maps(
            cfg, models, tgt, ref, on_device(inv_Ks), on_device(gt_smalls),
            on_device([s["gt_transformation"] for s in samples]), gauss_w)
        epipn_b, post_b, gtep_b = (x.cpu().numpy() for x in (epipn_b, post_b, gtep_b))

        for bi in range(n_valid):
            j = idxs[bi]
            sample = samples[bi]
            h, w = sample["tgt"].shape[:2]
            zoom_x, zoom_y = zooms[bi]

            # flow EPE at the frame's resolution, resized as (rows, cols):
            # the reference swaps the axes here, the JAX CLI fixes it
            gt_flow = sample["gt_flow_occ"]
            full_zoomed = _resized(full_b[bi], (h, w, 2), dev)
            full_zoomed[..., 0] /= zoom_x
            full_zoomed[..., 1] /= zoom_y
            noc_mask = sample["gt_flow_noc"][..., 2]
            if cfg.pred_errors:
                errors_full.append([
                    compute_epe(gt_flow, full_zoomed, gt_flow[..., 2]),
                    compute_epe(gt_flow, full_zoomed, noc_mask),
                ])

            if cfg.save_pred_motions:
                err_img = get_flow_error_image(gt_flow[..., :2], gt_flow[..., 2] > 0, noc_mask > 0, full_zoomed)
                tgt_small = _resize_u8(np.clip(sample["tgt"], 0, 255).astype(np.uint8), H, W)
                f_img = flow_to_image(full_b[bi].cpu().numpy())
                fe = _resized(err_img, (H, W, 3), dev)

                def expand(m):
                    return 255 * np.repeat(m[..., None], 3, -1)

                viz = np.hstack([tgt_small, f_img, fe, expand(epipn_b[bi]), expand(gtep_b[bi]),
                                 expand(post_b[bi])]).astype(np.uint8)
                imwrite(os.path.join(out_dir, f"{j}.png"), viz)

    if cfg.pred_errors:
        mean_errors = np.array(errors_full).mean(0)
        print("\n  " + ("{:>8} | " * 2).format("epe_all", "epe_noc"))
        print(("&{: 8.3f}  " * 2).format(*mean_errors.tolist()) + "\\\\")
        with open(os.path.join(out_dir, "result.txt"), "w") as f:
            write_result(f, mean_errors, ["epe_all", "epe_noc"])
        print("\n-> Done!")

    if cfg.save_pred_motions:
        print("Evaluation save to --> ", out_dir)
    return mean_errors if cfg.pred_errors else None


def main(argv: Sequence[str] | None = None) -> None:
    cfg, device = parse_eval_cli("MDN-SfM PyTorch evaluate_flow", argv)
    evaluate(cfg, device=device)


if __name__ == "__main__":
    main()
