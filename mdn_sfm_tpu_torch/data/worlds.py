"""Synthetic worlds on disk for the port's tools: KITTI-2015 scene flow
with calibration and semantics, GT mobile masks, odometry sequences, raw
drives, and street scenes with bright objects for the crafted detector
(:mod:`..masks.crafted`). The port's own copy of the JAX package's test
writers (``tests/fixtures.py``): the same arguments write the same bytes."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _write_png8(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr.astype(np.uint8)).save(path)


def write_png16(path: str, arr: np.ndarray) -> None:
    """16-bit PNG writer (PIL cannot write 16-bit RGB): color type 2 RGB or 0
    gray, bit depth 16."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if arr.ndim == 2:
        color_type = 0
        raw = b"".join(b"\x00" + arr[y].astype(">u2").tobytes() for y in range(arr.shape[0]))
        w = arr.shape[1]
    else:
        color_type = 2
        raw = b"".join(b"\x00" + arr[y].astype(">u2").tobytes() for y in range(arr.shape[0]))
        w = arr.shape[1]

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, arr.shape[0], 16, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def _calib_text(w: int, h: int) -> str:
    fx, fy = 0.9 * w, 1.5 * h
    cx, cy = w / 2, h / 2
    p2 = f"P_rect_02: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n"
    p3 = f"P_rect_03: {fx} 0 {cx} {-0.54 * fx} 0 {fy} {cy} 0 0 0 1 0\n"
    return p2 + p3


def make_kitti2015(root: str, n: int = 2, h: int = 48, w: int = 96, seed: int = 0) -> None:
    """data_scene_flow + calib + semantics + GT masks for n samples."""
    rng = np.random.default_rng(seed)
    for j in range(n):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        img2 = np.roll(img, 2, axis=1)
        base = os.path.join(root, "data_scene_flow", "training")
        _write_png8(os.path.join(base, "image_2", f"{j:06d}_10.png"), img)
        _write_png8(os.path.join(base, "image_2", f"{j:06d}_11.png"), img2)

        # GT flow: constant (2, 0) px, all valid — 16-bit KITTI encoding
        for occ in ("flow_occ", "flow_noc"):
            I = np.zeros((h, w, 3), np.uint16)
            I[..., 0] = int(2 * 64 + 2**15)
            I[..., 1] = int(0 * 64 + 2**15)
            I[..., 2] = 1
            write_png16(os.path.join(base, occ, f"{j:06d}_10.png"), I)

        calib_dir = os.path.join(root, "data_scene_flow_calib", "training", "calib_cam_to_cam")
        os.makedirs(calib_dir, exist_ok=True)
        with open(os.path.join(calib_dir, f"{j:06d}.txt"), "w") as f:
            f.write(_calib_text(w, h))

        # semantics: color image + 16-bit instance map with one car instance
        sem = os.path.join(root, "data_semantics", "training")
        _write_png8(os.path.join(sem, "image_2", f"{j:06d}_10.png"), img)
        inst = np.zeros((h, w), np.uint16)
        inst[h // 4 : h // 2, w // 4 : w // 2] = 26 * 256 + 1  # car instance
        write_png16(os.path.join(sem, "instance", f"{j:06d}_10.png"), inst)


def make_gt_masks(path: str, n: int = 2, h: int = 48, w: int = 96, seed: int = 1) -> None:
    rng = np.random.default_rng(seed)
    for j in range(n):
        mask = (rng.random((h, w)) > 0.8).astype(np.uint8) * 255
        _write_png8(os.path.join(path, f"{j}.png"), np.repeat(mask[..., None], 3, -1))


def make_odometry(root: str, seq: str = "09", n_frames: int = 5, h: int = 48, w: int = 96) -> None:
    rng = np.random.default_rng(2)
    seq_dir = os.path.join(root, "odometry_data", seq, "image_2")
    os.makedirs(seq_dir, exist_ok=True)
    for i in range(n_frames):
        _write_png8(os.path.join(seq_dir, f"{i:06d}.png"),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    poses_dir = os.path.join(root, "odometry_data", "poses")
    os.makedirs(poses_dir, exist_ok=True)
    poses = []
    for i in range(n_frames):
        M = np.eye(3, 4)
        M[2, 3] = 0.5 * i  # forward motion
        poses.append(M.reshape(-1))
    np.savetxt(os.path.join(poses_dir, f"{seq}.txt"), np.stack(poses))


def make_raw_drive(root: str, drive: str = "2011_09_26/2011_09_26_drive_0001_sync",
                   n_frames: int = 4, h: int = 48, w: int = 96) -> list[str]:
    """KITTI raw drive layout for the train reader; returns split lines."""
    rng = np.random.default_rng(3)
    day = drive.split("/")[0]
    img_dir = os.path.join(root, drive, "image_02", "data")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n_frames):
        _write_png8(os.path.join(img_dir, f"{i:010d}.png"),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    with open(os.path.join(root, day, "calib_cam_to_cam.txt"), "w") as f:
        f.write(_calib_text(w, h))
    return [f"{drive} {i} l" for i in range(1, n_frames - 1)]


def make_street_scene(h: int = 375, w: int = 1242, n_objects: int = 3,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Street-like frame for the crafted brightness detector: dark
    textured background + bright elliptical "vehicles". Returns
    (uint8 RGB (h, w, 3), bool GT object mask (h, w))."""
    rng = np.random.default_rng(seed)
    img = rng.integers(10, 40, (h, w, 3)).astype(np.uint8)
    gt = np.zeros((h, w), bool)
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(n_objects):
        oh = int(h * rng.uniform(0.12, 0.28))
        ow = int(oh * rng.uniform(1.2, 2.4))
        cy = int(rng.uniform(oh, h - oh))
        cx = int(rng.uniform(ow, w - ow))
        ell = ((ys - cy) / (oh / 2)) ** 2 + ((xs - cx) / (ow / 2)) ** 2 <= 1.0
        shade = rng.integers(200, 255)
        img[ell] = shade
        gt |= ell
    return img, gt
