"""Synthetic KITTI-shaped data — the port's own copy of
``mdn_sfm_tpu.data.synthetic.synthetic_intrinsics`` / ``synthetic_batch`` /
``SyntheticDataset``.
Plain numpy, so both packages see the same bytes for the same seed."""

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
