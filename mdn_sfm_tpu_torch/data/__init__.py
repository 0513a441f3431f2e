"""Input pipeline of the port: on-device augmentation and synthetic batches.
KITTI loading waits for a later slice."""

from .augment import MEAN, STD, augment_batch, draw_augment
from .synthetic import synthetic_batch, synthetic_intrinsics

__all__ = [
    "MEAN",
    "STD",
    "augment_batch",
    "draw_augment",
    "synthetic_batch",
    "synthetic_intrinsics",
]
