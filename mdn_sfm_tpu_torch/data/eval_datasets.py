"""Evaluation datasets — the part of ``mdn_sfm_tpu.data.eval_datasets`` that
the Trainer's inline validation reads: ``ValidationSet``, ``get_intrinsics``,
``prepare_pair`` and ``KittiSegDataset``. The rest comes with the eval CLIs.

Readers return numpy; resizing and normalization for the networks go
through :func:`prepare_pair`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import invert_intrinsics
from ..labels import kitti_decode
from ..native import mask_bbox, rle_encode
from ..viz import load_as_float
from .augment import MEAN, STD
from .kitti import _imread_rgb, _resize_u8, parse_calib_intrinsics


def get_intrinsics(calib_file: str, cam_id: int = 2) -> np.ndarray:
    """P_rect_{cam} of a KITTI calib file → (3, 4)."""
    return parse_calib_intrinsics(calib_file, cam_id)


def prepare_pair(tgt: np.ndarray, ref: np.ndarray, height: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Resize + normalize an image pair for the networks → (1, H, W, 3)
    float32 each."""
    out = []
    for img in (tgt, ref):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        if img.shape[:2] != (height, width):
            img = _resize_u8(img, height, width)
        out.append(((img.astype(np.float32) / 255.0) - MEAN) / STD)
    return out[0][None], out[1][None]


class ValidationSet:
    """KITTI-2015 scene-flow evaluation base: 200 frame pairs."""

    def __init__(self, root: str, n: int = 200, phase: str = "training", occ: str = "flow_occ"):
        self.root = root
        self.n = n
        self.phase = phase
        self.occ = occ

    def __len__(self) -> int:
        return self.n

    def _p(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def _frame(self, index: int, suffix: str) -> str:
        return self._p("data_scene_flow", self.phase, "image_2", f"{index:06d}_{suffix}.png")

    def _calib(self, index: int) -> str:
        return self._p("data_scene_flow_calib", self.phase, "calib_cam_to_cam", f"{index:06d}.txt")


class KittiSegDataset(ValidationSet):
    """KITTI-2015 pairs with intrinsics, the full-resolution instance image
    and per-instance annotations (bbox by the native ``mask_bbox``, RLE by
    the native codec).

    Returns a dict: ('color', 0/1) normalized (H, W, 3); 'K'/'inv_K' (4, 4);
    'instance_img' (375, 1242, 3) float; 'annotations' a list of dicts.
    """

    FULL_RES = (1242, 375)  # (W, H)

    def __init__(self, root: str, height: int, width: int, n: int = 200,
                 phase: str = "training", decoder=kitti_decode):
        super().__init__(root, n, phase)
        self.height = height
        self.width = width
        self.decoder = decoder

    def __getitem__(self, index: int) -> dict:
        if index >= len(self):
            raise IndexError
        inputs: dict = {}
        tgt = load_as_float(self._frame(index, "10"))
        next_tgt = load_as_float(self._frame(index, "11"))
        h, w = tgt.shape[:2]

        instance_path = self._p("data_semantics", self.phase, "image_2", f"{index:06d}_10.png")
        instance_img = np.asarray(_imread_rgb(instance_path), dtype=np.float32)
        inputs["instance_img"] = np.round(
            _resize_u8(instance_img.astype(np.uint8), self.FULL_RES[1], self.FULL_RES[0])
        ).astype(np.float32)

        c0, c1 = prepare_pair(tgt, next_tgt, self.height, self.width)
        inputs[("color", 0)] = c0[0]
        inputs[("color", 1)] = c1[0]

        intrinsics = get_intrinsics(self._calib(index)).astype("float32")[:, :3].copy()
        intrinsics[0] *= self.width / w
        intrinsics[1] *= self.height / h
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = intrinsics
        inputs["K"] = K
        inputs["inv_K"] = invert_intrinsics(torch.from_numpy(K)).numpy()

        # one annotation per instance id whose trainId is a thing class
        inst_gray_path = self._p("data_semantics", self.phase, "instance", f"{index:06d}_10.png")
        annotations = []
        if os.path.exists(inst_gray_path):
            from PIL import Image

            with Image.open(inst_gray_path) as im:
                inst = np.asarray(im)
            for label in np.unique(inst):
                train_id = self.decoder(int(label))
                if train_id in (0, 255):
                    continue
                roi = (inst == label).astype(np.uint8)
                bbox = mask_bbox(roi)
                if bbox is None:
                    continue
                annotations.append({
                    "bbox": bbox,
                    "bbox_mode": "XYXY_ABS",
                    "segmentation": rle_encode(roi),
                    "category_id": train_id - 1,
                })
        inputs["annotations"] = annotations
        return inputs
