"""Mobile-object ground-truth mask tooling — the port of
``tools/generate_mobile_gt.py``.

Two phases:

1. ``predict``: run the Mask R-CNN (:class:`~.masks.maskrcnn.MaskRCNNBackend`,
   detectron2's 1024-edge pipeline) over the KITTI semantics images and dump
   one PNG per detected instance to ``{pred_output}/{sample}/{instance}.png``.
   With ``--from_semantic_gt`` the instances come from the KITTI semantic
   instance maps instead (no model).
2. ``generate_masks``: union the moving-instance ids chosen by hand in
   ``{gt_output}/instance_numbers.txt`` (one line a sample) into binary GT
   masks ``{gt_output}/{n}.png``.

    python -m mdn_sfm_tpu_torch.generate_mobile_gt --phase predict --weights log/model_final_detectron2.pth
    python -m mdn_sfm_tpu_torch.generate_mobile_gt --phase generate_masks

The model runs on ``cuda`` unless ``--device`` names another device; the
semantic-GT and mask phases run on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import numpy as np

from .labels import kitti_decode
from .native import mask_union


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="The JAX tool's --spatial_shards (the backend's input sharded over a TPU mesh along the "
               "image width) has no counterpart here: one card runs the whole image.")
    parser.add_argument("--input", type=str, default="kitti/data_semantics/training/image_2",
                        help="directory of images to predict instances on")
    parser.add_argument("--instance_dir", type=str, default="kitti/data_semantics/training/instance",
                        help="KITTI semantic instance maps (for --from_semantic_gt)")
    parser.add_argument("--pred_output", type=str, default="output/prediction/detectron2/pred_masks",
                        help="where per-instance mask PNGs are dumped")
    parser.add_argument("--gt_output", type=str, default="output/mobile_objects_ground_truth",
                        help="where the final GT masks are written")
    parser.add_argument("--phase", choices=["predict", "generate_masks"], default="generate_masks")
    parser.add_argument("--from_semantic_gt", action="store_true",
                        help="derive per-instance masks from the KITTI semantic instance maps instead of a model")
    parser.add_argument("--n_samples", type=int, default=200)
    parser.add_argument("--weights", type=str, default="", help="detectron2 .pth for the predict phase")
    parser.add_argument("--device", type=str, default="cuda", help="the model's device (default: cuda)")
    return parser


def _imwrite(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def predict_from_semantic_gt(args) -> None:
    """One PNG per thing-class instance of the KITTI instance maps: a
    model-free stand-in for the ``predict`` phase (the manual selection step
    after it is the same)."""
    from PIL import Image

    files = sorted(f for f in os.listdir(args.instance_dir) if f.endswith("_10.png"))[: args.n_samples]
    for n, fname in enumerate(files):
        with Image.open(os.path.join(args.instance_dir, fname)) as im:
            inst = np.asarray(im)
        i = 0
        for label in np.unique(inst):
            if kitti_decode(int(label)) in (0, 255):
                continue
            mask = np.where(inst == label, 255, 0).astype(np.uint8)
            _imwrite(os.path.join(args.pred_output, str(n), f"{i}.png"), np.repeat(mask[..., None], 3, -1))
            i += 1
        print(f"{n}: {i} instances")


def predict_with_model(args, backend=None) -> None:
    """Run the Mask R-CNN over the input images, one image a forward, and
    dump each detection's full-resolution mask. ``backend``: a ready
    :class:`~.masks.maskrcnn.MaskRCNNBackend` (by default the 1024-edge one,
    with ``--weights`` or random weights, on ``--device``)."""
    from PIL import Image

    if backend is None:
        from .masks.maskrcnn import MaskRCNNBackend

        if not args.weights:
            print("WARNING: no --weights given — predicting with RANDOM Mask R-CNN "
                  "weights; the dumped instance masks will be garbage.", flush=True)
        backend = MaskRCNNBackend(weights_path=args.weights or None, device=args.device)
    files = sorted(os.path.join(args.input, f) for f in os.listdir(args.input)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))[: args.n_samples]
    print(f"There are {len(files)} images to predict.")
    for n, path in enumerate(files):
        with Image.open(path) as im:
            img = np.asarray(im.convert("RGB"))
        masks, _boxes, _classes, _scores = backend.predict(img)
        for i, mask in enumerate(masks):
            _imwrite(os.path.join(args.pred_output, str(n), f"{i}.png"), np.repeat((mask * 255)[..., None], 3, -1))


def generate_masks(args) -> None:
    """Each sample's listed instances unioned ×255 into ``{gt_output}/{n}.png``;
    a sample with no listed instance gets a 1×1 zero PNG."""
    from PIL import Image

    numbers_file = os.path.join(args.gt_output, "instance_numbers.txt")
    with open(numbers_file) as f:
        instance_numbers = [line.split() for line in f.readlines()]
    assert len(instance_numbers) == args.n_samples, "Invalid instance numbers input!"

    for n in range(args.n_samples):
        masks = []
        for num in instance_numbers[n]:
            with Image.open(os.path.join(args.pred_output, str(n), f"{num}.png")) as im:
                masks.append(np.asarray(im.convert("L")))
        gt = mask_union(np.stack(masks)) * 255 if masks else np.zeros((1, 1), np.uint8)
        _imwrite(os.path.join(args.gt_output, f"{n}.png"), gt)
    print(f"Wrote {args.n_samples} GT masks to {args.gt_output}")


def main(argv: Sequence[str] | None = None) -> None:
    args = get_argparser().parse_args(argv)
    if args.phase == "predict":
        if args.from_semantic_gt:
            predict_from_semantic_gt(args)
        else:
            predict_with_model(args)
    else:
        generate_masks(args)


if __name__ == "__main__":
    main()
