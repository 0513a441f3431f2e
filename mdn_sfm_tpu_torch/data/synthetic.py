"""Synthetic KITTI-shaped data — the port's own copy of
``mdn_sfm_tpu.data.synthetic.synthetic_intrinsics`` / ``synthetic_batch`` /
``moving_object_batch`` / ``SyntheticDataset``.
Plain numpy (and cv2's resize), so both packages see the same bytes for the
same seed."""

from __future__ import annotations

import numpy as np


def synthetic_intrinsics(height: int, width: int) -> np.ndarray:
    """KITTI-like intrinsics already rescaled to (width, height):
    fx≈0.58·W, fy≈1.92·H, principal point at the centre."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = 0.58 * width
    K[1, 1] = 1.92 * height
    K[0, 2] = 0.5 * width
    K[1, 2] = 0.5 * height
    return K


def synthetic_batch(
    batch_size: int,
    height: int,
    width: int,
    num_frames: int = 3,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Random smooth image triplets + intrinsics.

    Returns colors_u8 (B, F, H, W, 3) uint8 and K (B, 4, 4) float32. Frames
    are shifted copies of a random low-frequency pattern, so the flow between
    them is non-degenerate.
    """
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, size=(batch_size, height // 8, width // 8, 3))
    base = base.repeat(8, axis=1).repeat(8, axis=2)

    frames = [np.roll(base, 2 * f, axis=2) for f in range(num_frames)]
    colors = np.stack(frames, axis=1).astype(np.uint8)  # (B, F, H, W, 3)

    K = np.broadcast_to(synthetic_intrinsics(height, width), (batch_size, 4, 4)).copy()
    return colors, K


def _smooth_texture(
    rng: np.random.Generator, height: int, width: int, lo: float = 0.0, hi: float = 255.0
) -> np.ndarray:
    """Low-frequency RGB texture in [lo, hi] with non-zero gradients
    everywhere (bilinear upsample of coarse noise: piecewise-constant
    textures give the photometric loss no gradient inside each block)."""
    import cv2

    low = rng.uniform(lo, hi, size=(max(height // 8, 2), max(width // 8, 2), 3))
    return cv2.resize(low.astype(np.float32), (width, height), interpolation=cv2.INTER_LINEAR)


def moving_object_batch(
    batch_size: int,
    height: int,
    width: int,
    num_frames: int = 3,
    seed: int = 0,
    bg_shift: int = 2,
    obj_shift: int = 3,
    obj_size: int | None = None,
    bright_object: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, list[int]]:
    """A world with a KNOWN moving object, for the two-stage rehearsal.

    The background is a fronto-parallel textured plane seen by a camera
    translating along x: uniform horizontal flow ``t·bg_shift`` px for frame
    offset t, consistent with cam_T_cam = (R=I, translation=(c, 0, 0)) for
    any c (horizontal epipolar lines). A square textured patch moves
    VERTICALLY by ``t·obj_shift`` px and so violates that constraint: a
    trained mobile decoder must light up on it. ``bright_object``: a dark
    background (10-110) and a bright patch (200-255), which the crafted
    brightness detector (``masks/crafted.py``) sees. Frames are ordered
    like ``cfg.frame_ids`` = (0, -1, 1).

    Returns:
        colors_u8 (B, F, H, W, 3) uint8; K (B, 4, 4) float32; gt_mask
        (B, H, W) float32, the patch in the target frame; gt_flows (B, F,
        H, W, 2) float32 pixel flow target → frame f; times, the frame
        offsets (0, -1, 1).
    """
    if obj_size is None:
        obj_size = height // 3
    times = [0, -1, 1][:num_frames]
    margin = abs(obj_shift) * (max(abs(t) for t in times)) + 2

    rng = np.random.default_rng(seed)
    colors = np.zeros((batch_size, num_frames, height, width, 3), np.uint8)
    gt_mask = np.zeros((batch_size, height, width), np.float32)
    gt_flows = np.zeros((batch_size, num_frames, height, width, 2), np.float32)

    for b in range(batch_size):
        if bright_object:
            base = _smooth_texture(rng, height, width, lo=10, hi=110)
            patch = _smooth_texture(rng, obj_size, obj_size, lo=200, hi=255)
        else:
            base = _smooth_texture(rng, height, width)
            patch = _smooth_texture(rng, obj_size, obj_size)
        # the patch stays clear of the image borders at every frame offset
        y0 = int(rng.integers(margin, height - obj_size - margin))
        x0 = int(rng.integers(abs(bg_shift) + 2, width - obj_size - abs(bg_shift) - 2))
        gt_mask[b, y0:y0 + obj_size, x0:x0 + obj_size] = 1.0

        for f, t in enumerate(times):
            frame = np.roll(base, t * bg_shift, axis=1)  # camera translation
            oy = y0 + t * obj_shift
            frame[oy:oy + obj_size, x0:x0 + obj_size] = patch
            colors[b, f] = np.clip(frame, 0, 255).astype(np.uint8)

            gt_flows[b, f, :, :, 0] = t * bg_shift
            gt_flows[b, f, :, :, 1] = 0.0
            on = gt_mask[b] > 0
            gt_flows[b, f, :, :, 0][on] = 0.0
            gt_flows[b, f, :, :, 1][on] = t * obj_shift

    K = np.broadcast_to(synthetic_intrinsics(height, width), (batch_size, 4, 4)).copy()
    return colors, K, gt_mask, gt_flows, times


class SyntheticDataset:
    """Map-style dataset over :func:`synthetic_batch` items: item ``i`` is
    ``synthetic_batch(1, H, W, F, seed=i)``."""

    def __init__(self, n: int, height: int, width: int, num_frames: int = 3):
        self.n = n
        self.height = height
        self.width = width
        self.num_frames = num_frames

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        colors, K = synthetic_batch(1, self.height, self.width, self.num_frames, seed=index)
        return colors[0], K[0]
