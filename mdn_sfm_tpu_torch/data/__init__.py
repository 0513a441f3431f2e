"""Input pipeline of the port: the host decodes (KITTI raw through the split
manifests, or synthetic triplets) and the card augments."""

from .augment import MEAN, STD, augment_batch, draw_augment, eval_preprocess
from .cache import DecodedCache
from .kitti import KittiRawDataset, parse_calib_intrinsics
from .loader import HostLoader, Subset
from .splits import read_split_lines, split_path
from .synthetic import SyntheticDataset, moving_object_batch, synthetic_batch, synthetic_intrinsics

__all__ = [
    "MEAN",
    "STD",
    "DecodedCache",
    "HostLoader",
    "KittiRawDataset",
    "Subset",
    "SyntheticDataset",
    "augment_batch",
    "draw_augment",
    "eval_preprocess",
    "moving_object_batch",
    "parse_calib_intrinsics",
    "read_split_lines",
    "split_path",
    "synthetic_batch",
    "synthetic_intrinsics",
]
