"""Evaluation datasets — the port's own copy of
``mdn_sfm_tpu.data.eval_datasets``: the KITTI-2015 scene-flow readers (flow,
mobile masks, segmentation with instance annotations), the Eigen-val raw
pairs and the odometry snippets.

Readers return numpy; resizing and normalization for the networks go
through :func:`prepare_pair`.
"""

from __future__ import annotations

import os
import random
from typing import Iterator

import numpy as np
import torch

from ..geometry import invert_intrinsics
from ..labels import kitti_decode
from ..native import mask_bbox, rle_encode
from ..viz import flow_read_png, load_as_float
from .augment import MEAN, STD
from .kitti import SIDE_MAP, _imread_rgb, _resize_u8, parse_calib_intrinsics


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


class ValidationFlow(ValidationSet):
    """Pairs with GT flow (occ and noc, (H, W, 3) = u, v, valid) and the
    calibration: intrinsics, and the stereo baseline as the GT transform."""

    def __getitem__(self, index: int) -> dict:
        if index >= len(self):
            raise IndexError
        tgt = load_as_float(self._frame(index, "10"))
        next_tgt = load_as_float(self._frame(index, "11"))
        gt = {}
        for occ in ("flow_occ", "flow_noc"):
            u, v, valid = flow_read_png(self._p("data_scene_flow", self.phase, occ, f"{index:06d}_10.png"))
            gt[occ] = np.dstack((u, v, valid))
        intrinsics = get_intrinsics(self._calib(index)).astype("float32")[:, :3]
        translation = get_intrinsics(self._calib(index), cam_id=3).astype("float32")[:, 3][:, None]
        gt_transformation = np.hstack([np.eye(3), translation]).astype(np.float32)
        return {
            "tgt": tgt,
            "next_tgt": next_tgt,
            "gt_flow_occ": gt["flow_occ"],
            "gt_flow_noc": gt["flow_noc"],
            "intrinsics": intrinsics,
            "translation": translation,
            "gt_transformation": gt_transformation,
        }


class ValidationMobileMask(ValidationSet):
    """Just the image pairs."""

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        if index >= len(self):
            raise IndexError
        return load_as_float(self._frame(index, "10")), load_as_float(self._frame(index, "11"))


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


class ValidationMobileMaskMore:
    """Eigen-val image pairs from the raw dataset: each split line
    ("folder frame side") yields {'tgt', 'next_tgt', 'intrinsics' (3, 3)}."""

    def __init__(self, root: str, files: list[str], phase: str = "raw_data"):
        self.root = root
        self.files = files
        self.phase = phase

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        folder, num, side = self.files[index].split()
        num = int(num)
        cam = SIDE_MAP[side]
        base = os.path.join(self.root, self.phase, folder, f"image_0{cam}/data")
        tgt = load_as_float(os.path.join(base, f"{num:010d}.png"))
        next_tgt = load_as_float(os.path.join(base, f"{num + 1:010d}.png"))
        calib = os.path.join(self.root, self.phase, folder.split("/")[0], "calib_cam_to_cam.txt")
        intrinsics = get_intrinsics(calib, cam).astype("float32")[:, :3]
        return {"tgt": tgt, "next_tgt": next_tgt, "intrinsics": intrinsics}


def check_next_frame(files: list[str], raw_dataset_dir: str, choose: int = 400, seed: int = 0) -> list[str]:
    """Drop split lines whose next frame is missing on disk, then sample
    ``choose`` of the rest (``random.Random(seed)``)."""
    kept = []
    for f in files:
        folder, num, side = f.split()
        p = os.path.join(raw_dataset_dir, "raw_data", folder, f"image_0{SIDE_MAP[side]}/data",
                         f"{int(num) + 1:010d}.png")
        if os.path.exists(p):
            kept.append(f)
    chosen = random.Random(seed).sample(kept, min(choose, len(kept)))
    print(
        f"There are {len(files)} files in training dataset, delete "
        f"{len(files) - len(kept)} items, {len(kept)} items left; now we "
        f"choose {len(chosen)} items to evaluate."
    )
    return chosen


class OdometryFramework:
    """KITTI odometry snippets of ``seq_length`` frames centred on each
    target frame: {'imgs': the images, 'path': the first image's path,
    'poses': (seq_len, 3, 4) GT poses relative to the first}."""

    def __init__(self, root: str, sequence_set: list[str], seq_length: int = 3, step: int = 1):
        self.root = root
        self.img_files: list[list[str]] = []
        self.poses: list[np.ndarray] = []
        self.sample_indices: list[np.ndarray] = []

        demi = (seq_length - 1) // 2
        shift = np.array([step * i for i in range(-demi, demi + 1)]).reshape(1, -1)

        sequences = []
        seq_root = os.path.join(root, "sequences")
        base = seq_root if os.path.isdir(seq_root) else root
        for seq in sequence_set:
            for d in sorted(os.listdir(base)):
                if d.startswith(str(seq)) and os.path.isdir(os.path.join(base, d)):
                    sequences.append(os.path.join(base, d))

        for sequence in sequences:
            name = os.path.basename(sequence)
            poses = np.genfromtxt(os.path.join(root, "poses", f"{name}.txt")).astype(np.float64).reshape(-1, 3, 4)
            img_dir = os.path.join(sequence, "image_2")
            imgs = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir) if f.endswith(".png"))
            tgt = np.arange(demi, len(imgs) - demi).reshape(-1, 1)
            self.img_files.append(imgs)
            self.poses.append(poses)
            self.sample_indices.append(shift + tgt)

    def __len__(self) -> int:
        return sum(len(s) for s in self.sample_indices)

    def _make_sample(self, img_list: list[str], pose_list: np.ndarray, snippet) -> dict:
        imgs = [load_as_float(img_list[i]) for i in snippet]
        poses = np.stack([pose_list[i] for i in snippet])
        first = poses[0]
        poses[:, :, -1] -= first[:, -1]
        compensated = np.linalg.inv(first[:, :3]) @ poses
        return {"imgs": imgs, "path": img_list[snippet[0]], "poses": compensated}

    def __getitem__(self, index: int) -> dict:
        for img_list, pose_list, samples in zip(self.img_files, self.poses, self.sample_indices):
            if index < len(samples):
                return self._make_sample(img_list, pose_list, samples[index])
            index -= len(samples)
        raise IndexError(index)

    def __iter__(self) -> Iterator[dict]:
        for img_list, pose_list, samples in zip(self.img_files, self.poses, self.sample_indices):
            for snippet in samples:
                yield self._make_sample(img_list, pose_list, snippet)
