"""Quantify the live provider's ``d2_infer_scale`` resolution deviation — the
port of ``tools/quantify_d2_scale.py``.

The training-time :class:`~.masks.maskrcnn.MaskRCNNProvider` infers at
``d2_infer_scale ×`` the training resolution (by default 2× = 384×1280),
while the reference upsamples every frame to 375×1242 and runs detectron2 at
shortest-edge 1024 (the GT tooling's :class:`~.masks.maskrcnn.MaskRCNNBackend`
keeps that pipeline). This tool measures how far the UNION MASKS, the DS/DC
supervision signal, differ between the paths with identical weights.

Real trained weights are not in the repository, so the measurement uses the
crafted scale-covariant brightness detector (:mod:`.masks.crafted`): its
features are the local mean brightness at every resolution, so any
disagreement is the pipeline's (anchor coverage at the reduced resolution,
the fast proposal budget, bf16 ROIAlign, the 28×28 masks, paste
quantization), the mechanisms that would shift DS/DC supervision under real
weights.

Reports per image and as means: the union-mask IoU (provider at each scale
against the 1024-edge backend, both binarized at the training resolution),
the backend's IoU against the scenes' GT objects, and the detection counts.
One JSON line at the end.

    python -m mdn_sfm_tpu_torch.quantify_d2_scale [--n_images 6] [--scales 1 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Sequence

import numpy as np

SCENE_HW = (375, 1242)  # a KITTI raw frame
N_OBJECTS = 3


def _iou(a, b) -> float:
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    union = (a | b).sum()
    return round(float((a & b).sum() / max(union, 1)), 4)


def build_pipelines(scales: Sequence[int], height: int, width: int, max_det: int,
                    input_hw: tuple[int, int] | None = None, fast: bool = False, device=None):
    """The backend (``input_hw``: its static padded input, by default the
    1024-edge 640×2048) and one provider a scale, all on the crafted
    detector, on ``device`` (``cuda`` unless asked otherwise). Returns
    (backend, {scale: provider})."""
    from .config import Config, Mode
    from .masks.crafted import brightness_detector_state_dict
    from .masks.maskrcnn import MaskRCNNBackend, MaskRCNNProvider

    crafted = brightness_detector_state_dict()
    print("building the 1024-edge backend (the reference-resolution pipeline)...", flush=True)
    backend = MaskRCNNBackend(crafted, max_det=max_det, fast=fast, input_hw=input_hw, device=device)
    providers = {}
    for s in scales:
        cfg = Config(height=height, width=width, mode=Mode.DS, mask_provider="maskrcnn",
                     d2_max_instances=max_det, d2_infer_scale=s, d2_allow_random_weights=True).validate()
        print(f"building the provider at scale {s} ({height * s}x{width * s})...", flush=True)
        providers[s] = MaskRCNNProvider(cfg, device=device, weights=crafted)
    return backend, providers


def measure(backend, providers: dict, n_images: int, height: int, width: int,
            scene_hw: tuple[int, int] = SCENE_HW) -> tuple[list[dict], dict]:
    """One row a street scene (seed = its index) and the summary."""
    import cv2

    from .data.worlds import make_street_scene

    rows = []
    for i in range(n_images):
        img, gt = make_street_scene(h=scene_hw[0], w=scene_hw[1], n_objects=N_OBJECTS, seed=i)
        masks, _boxes, _cls, _scores = backend.predict(img)
        union_full = masks.any(axis=0).astype(np.float32)
        # the comparison grid is the training resolution, which the DS/DC loss consumes
        ref = cv2.resize(union_full, (width, height), interpolation=cv2.INTER_AREA) > 0.5
        gt_small = cv2.resize(gt.astype(np.float32), (width, height), interpolation=cv2.INTER_AREA) > 0.5
        row = {"image": i, "n_backend": int(masks.shape[0]), "backend_iou_vs_gt": _iou(ref, gt_small)}
        for s, prov in providers.items():
            u = prov.union_masks_from_images(img[None], height, width).cpu().numpy()[0] > 0.5
            row[f"iou_s{s}"] = _iou(u, ref)
            row[f"n_s{s}"] = prov.count_detections(img[None])[0]
        rows.append(row)
        print(row, flush=True)

    summary = {
        "metric": "d2_infer_scale_union_mask_iou_vs_1024edge",
        "n_images": n_images,
        "mean_backend_iou_vs_gt": round(float(np.mean([r["backend_iou_vs_gt"] for r in rows])), 4),
        "mean_n_backend": round(float(np.mean([r["n_backend"] for r in rows])), 2),
    }
    for s in providers:
        summary[f"mean_iou_scale{s}"] = round(float(np.mean([r[f"iou_s{s}"] for r in rows])), 4)
        summary[f"mean_n_scale{s}"] = round(float(np.mean([r[f"n_s{s}"] for r in rows])), 2)
    return rows, summary


def quantify(n_images: int = 6, scales: Sequence[int] = (1, 2), height: int = 192, width: int = 640,
             max_det: int = 32, scene_hw: tuple[int, int] = SCENE_HW, input_hw: tuple[int, int] | None = None,
             fast: bool = False, device=None) -> tuple[list[dict], dict]:
    """:func:`build_pipelines`, then :func:`measure`."""
    backend, providers = build_pipelines(scales, height, width, max_det, input_hw, fast, device)
    return measure(backend, providers, n_images, height, width, scene_hw)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_images", type=int, default=6)
    p.add_argument("--scales", type=int, nargs="+", default=[1, 2])
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max_det", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    _rows, summary = quantify(args.n_images, args.scales, args.height, args.width, args.max_det,
                              device=args.device)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
