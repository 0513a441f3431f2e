"""Mobile-mask evaluation against Detectron2-derived GT masks — the port of
the root ``evaluate_mix.py``, the metric path behind the README table.

    python -m mdn_sfm_tpu_torch.evaluate_mix --data_root kitti --version v1 --idx 0 \\
        --gt_mask_path output/mobile_objects_ground_truth --binary_threshold 0.18
    python -m mdn_sfm_tpu_torch.evaluate_mix ... --device cpu

Per batch of ``eval_batch_size`` KITTI-2015 samples, on the device: the eval
forward, then ONE epipolar launch for the batch's |residual| map and the SN
post-processing of the viz maps. Per sample: the mobile map upsampled to the
GT mask's resolution on the device, then binarized and scored on the host
(accuracy, precision, recall, F1, Dice), and the five-panel PNG.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Sequence

import numpy as np
import torch

from . import training as T
from .config import Config, Mode, parse_eval_cli
from .data.eval_datasets import KittiSegDataset
from .data.kitti import _resize_u8
from .geometry import resize_linear
from .labels import TRAINID2LABEL
from .losses import epipolar_loss_terms
from .metrics import binary_image, get_quantitative_results
from .ops.epipolar import EpipolarMap, epipolar_abs_residual_maps
from .utils import eval_chunks, resolve_device
from .viz import draw_boxes_rgb, imwrite, load_as_float, normalize_image

Tensor = torch.Tensor


def eval_maps(
    cfg: Config, models: T.ModelBundle, tgt: Tensor, ref: Tensor, inv_K: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """The batched eval step on a normalized (B, H, W, 3) pair and its (B, 4,
    4) inverse intrinsics: (mobile, post, ori), each (B, H, W, 1) float32.
    The viz maps are always SN's, as the reference's eval path computes them;
    the |residual| map is one kernel launch on the card."""
    flows, mobiles, _, _, cam = T.eval_forward(cfg, models, tgt, ref)
    (resid,) = epipolar_abs_residual_maps(
        [EpipolarMap(flows[0].float(), (float(cfg.width), float(cfg.height)), inv_K,
                     cam[:, :3, :3], cam[:, :3, 3])])
    viz_cfg = dataclasses.replace(cfg, mode=Mode.SN, w_d2_sim=0.0)
    _, post, ori = epipolar_loss_terms(viz_cfg, resid, mobiles[0], None, None)
    return mobiles[0].float(), post, ori


def predict(
    cfg: Config, models: T.ModelBundle, dataset: KittiSegDataset, device: torch.device
) -> Iterator[tuple[int, dict, Tensor, np.ndarray, np.ndarray]]:
    """Yield (index, inputs, mobile (H, W) on the device, post (H, W), ori
    (H, W)) per sample, from one :func:`eval_maps` call a batch."""
    for idxs, n_valid in eval_chunks(len(dataset), cfg.eval_batch_size):
        batch = [dataset[j] for j in idxs[:n_valid]]
        stacked = batch + [batch[-1]] * (len(idxs) - n_valid)

        def on_device(key):
            return torch.from_numpy(np.stack([x[key] for x in stacked])).to(device)

        mobile, post, ori = eval_maps(cfg, models, on_device(("color", 0)), on_device(("color", 1)),
                                      on_device("inv_K"))
        post, ori = post[..., 0].cpu().numpy(), ori[..., 0].cpu().numpy()
        for bi in range(n_valid):
            yield idxs[bi], batch[bi], mobile[bi, ..., 0], post[bi], ori[bi]


def read_gt_mask(gt_mask_path: str, j: int) -> np.ndarray | None:
    """Sample ``j``'s GT mask in [0, 1] (first channel), or None when it has
    none: the reference then skips the sample (no metric, no panel)."""
    path = os.path.join(gt_mask_path, f"{j}.png")
    if not os.path.exists(path):
        return None
    gt = load_as_float(path) / 255.0
    return gt[..., 0] if gt.ndim == 3 else gt


def at_resolution(mobile: Tensor, shape: tuple[int, int]) -> np.ndarray:
    """The mobile map at the GT mask's resolution, on the host: the
    prediction is upsampled, then binarized (PARITY.md's decision)."""
    if tuple(mobile.shape) != tuple(shape):
        mobile = resize_linear(mobile, shape)
    return mobile.cpu().numpy()


def evaluate(cfg: Config, thresholds: Sequence[float] | None = None, device: str | torch.device | None = None):
    """Run the metric path on ``device`` (``cuda`` unless asked otherwise);
    returns the mean [acc, prec, recall, f1, dice] row (1, 5) at
    ``cfg.binary_threshold``.

    ``thresholds``: extra binarization thresholds scored in the same pass
    (one forward, many binarizations), the self-calibration sweep for the
    resolution quirk (PARITY.md). When given, returns (row, {threshold: row})."""
    dev = resolve_device(device)
    models = T.load_eval_models(cfg, dev)
    dataset = KittiSegDataset(cfg.data_root, cfg.height, cfg.width, n=cfg.eval_num_samples)
    out_dir = os.path.join(cfg.eval_out_dir, "mobile", f"masks_{cfg.version}_{cfg.idx}")
    if cfg.save_pred_masks:
        os.makedirs(out_dir, exist_ok=True)

    print(f"-> Computing predictions with size {cfg.width}x{cfg.height}")
    print("-> Evaluating\n   Mono evaluation - using median scaling")

    metrics = []
    sweep: dict[float, list] = {t: [] for t in (thresholds or [])}
    for j, inputs, mobile, post, ori in predict(cfg, models, dataset, dev):
        gt_mask = read_gt_mask(cfg.gt_mask_path, j)
        if gt_mask is None:
            continue
        pred = at_resolution(mobile, gt_mask.shape)
        metrics.append(get_quantitative_results(binary_image(pred, cfg.binary_threshold), gt_mask))
        for t, rows in sweep.items():
            rows.append(get_quantitative_results(binary_image(pred, t), gt_mask))
        if cfg.save_pred_masks:
            imwrite(os.path.join(out_dir, f"{j}.png"), panel(cfg, inputs, mobile.cpu().numpy(), post, ori))

    if cfg.save_pred_masks:
        print("Evaluation save to --> ", out_dir)
    result = np.mean(np.array(metrics), axis=0, keepdims=True)
    print(result)
    print("\n-> Done!")
    if thresholds:
        return result, {t: np.mean(np.array(v), axis=0, keepdims=True) for t, v in sweep.items()}
    return result


def panel(cfg: Config, inputs: dict, mobile: np.ndarray, post: np.ndarray, ori: np.ndarray) -> np.ndarray:
    """The reference's stacked panel, uint8: [instance boxes | binary mask |
    mobile | post epipolar | ori epipolar], each (H, W, 3) at net resolution."""
    inst = np.clip(inputs["instance_img"], 0, 255).astype(np.uint8)
    boxes = [list(a["bbox"]) for a in inputs["annotations"]]
    colors = [TRAINID2LABEL[a["category_id"] + 1].color for a in inputs["annotations"]]
    seg_small = _resize_u8(draw_boxes_rgb(inst, np.array(boxes).reshape(-1, 4), colors), cfg.height, cfg.width)

    def expand(g):
        return np.repeat(g[..., None], 3, -1)

    return np.hstack([
        seg_small,
        255 * expand(binary_image(mobile, cfg.binary_threshold)),
        255 * expand(mobile),
        255 * expand(normalize_image(post)),
        255 * expand(normalize_image(ori)),
    ]).astype(np.uint8)


def main(argv: Sequence[str] | None = None) -> None:
    cfg, device = parse_eval_cli("MDN-SfM PyTorch evaluate_mix", argv)
    evaluate(cfg, device=device)


if __name__ == "__main__":
    main()
