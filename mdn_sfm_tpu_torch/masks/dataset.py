"""Instance-segmentation dataset builders — the port of
``mdn_sfm_tpu.masks.dataset``.

Per-image annotation dicts in detectron2's registration format
(file_name/image_id/height/width, and per instance its bbox, COCO RLE
segmentation and category_id) from KITTI or Cityscapes instance maps, through
the port's native RLE codec. They feed Mask R-CNN fine-tuning and the GT
tooling.
"""

from __future__ import annotations

import glob
import os
from typing import Callable

import numpy as np

from ..labels import THING_CLASSES_8, THING_CLASSES_11, cityscapes_pm_decode, kitti_decode, kitti_decode8
from ..native import mask_bbox, rle_encode


def instances_from_map(instance_img: np.ndarray, decoder: Callable[[int], int]) -> list[dict]:
    """The annotations of one instance-id map: one per value whose trainId
    is a thing class (0 and 255 are skipped), ``category_id = trainId − 1``."""
    objects = []
    for label in np.unique(instance_img):
        train_id = decoder(int(label))
        if train_id in (0, 255):
            continue
        roi = (instance_img == label).astype(np.uint8)
        bbox = mask_bbox(roi)
        if bbox is None:
            continue
        objects.append({
            "bbox": bbox,
            "bbox_mode": "XYXY_ABS",
            "segmentation": rle_encode(roi),
            "category_id": train_id - 1,
        })
    return objects


def create_dataset_dict(instance_files: list[str], image_files: list[str],
                        decoder: Callable[[int], int] = kitti_decode) -> list[dict]:
    """One dict per (instance map, image) pair, paired by position."""
    from PIL import Image

    dataset = []
    for instance_file, image_file in zip(instance_files, image_files):
        with Image.open(instance_file) as im:
            instance_img = np.asarray(im)
        h, w = instance_img.shape[:2]
        dataset.append({
            "file_name": image_file,
            "image_id": os.path.basename(image_file),
            "height": h,
            "width": w,
            "annotations": instances_from_map(instance_img, decoder),
        })
    return dataset


def _sorted_files(directory: str) -> list[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if os.path.isfile(os.path.join(directory, f)))


def kitti_seg_instance(dataset_dir: str, train: bool = True,
                       decoder: Callable[[int], int] = kitti_decode) -> list[dict]:
    """KITTI semantics (``{training,validation}/{instance,image_2}``) →
    annotation dicts."""
    sub = "training" if train else "validation"
    return create_dataset_dict(_sorted_files(os.path.join(dataset_dir, sub, "instance")),
                               _sorted_files(os.path.join(dataset_dir, sub, "image_2")), decoder)


def cityscapes_pm_seg_instance(dataset_dir: str, train: bool = True,
                               decoder: Callable[[int], int] = cityscapes_pm_decode) -> list[dict]:
    """Cityscapes gtFine instanceIds → annotation dicts: the standard tree,
    ``gtFine/{split}/{city}/*_gtFine_instanceIds.png`` paired with
    ``leftImg8bit/{split}/{city}/*_leftImg8bit.png``, sorted."""
    sub = "train" if train else "val"
    inst = sorted(glob.glob(os.path.join(dataset_dir, "gtFine", sub, "*", "*_gtFine_instanceIds.png")))
    imgs = sorted(glob.glob(os.path.join(dataset_dir, "leftImg8bit", sub, "*", "*_leftImg8bit.png")))
    return create_dataset_dict(inst, imgs, decoder)


DATASET_VARIANTS = {
    # name → (walker, decoder, thing classes). The reference's catalog
    # registers cityscapes_pm_instance with the KITTI walker and the
    # Cityscapes decoder; the Cityscapes walker above is never wired into
    # it. The catalog keeps that pairing under the reference's name.
    "kitti_seg_instance": (kitti_seg_instance, kitti_decode, THING_CLASSES_11),
    "kitti_seg_instance8": (kitti_seg_instance, kitti_decode8, THING_CLASSES_8),
    "cityscapes_pm_instance": (kitti_seg_instance, cityscapes_pm_decode, THING_CLASSES_11),
}
