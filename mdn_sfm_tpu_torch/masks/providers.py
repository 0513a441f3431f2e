"""Instance-mask providers — the port of ``mdn_sfm_tpu.masks.providers``.

A provider maps a batch's sample keys to (B, H, W) float32 union masks in
[0, 1] that ride with the batch into the train step: the static-shape
stand-in for detectron2's per-image instance lists.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence

import numpy as np


class MaskProvider(Protocol):
    def union_masks(self, keys: Sequence[str], height: int, width: int) -> np.ndarray:
        """Return (B, height, width) float32 union masks in [0, 1]."""
        ...


class NullMaskProvider:
    """All-zero masks: the BCE term becomes a push-to-zero regularizer and
    DS masking zeroes the epipolar term (use with w_d2_sim=0 for SN/T/TG)."""

    def union_masks(self, keys: Sequence[str], height: int, width: int) -> np.ndarray:
        return np.zeros((len(keys), height, width), np.float32)


class PrecomputedMaskProvider:
    """Per-sample union-mask PNGs ``{mask_dir}/{key}.png``: any nonzero pixel
    counts as instance; a missing file gives zeros; a mask of another size is
    resized by PIL's BILINEAR on the ×255 mask, then ÷255."""

    def __init__(self, mask_dir: str):
        self.mask_dir = mask_dir
        self._cache: dict[tuple[str, int, int], np.ndarray] = {}

    def _load(self, key: str, height: int, width: int) -> np.ndarray:
        ck = (key, height, width)
        if ck in self._cache:
            return self._cache[ck]
        path = os.path.join(self.mask_dir, f"{key}.png")
        if not os.path.exists(path):
            out = np.zeros((height, width), np.float32)
        else:
            from PIL import Image

            with Image.open(path) as im:
                out = (np.asarray(im.convert("L"), dtype=np.float32) != 0).astype(np.float32)
            if out.shape != (height, width):
                im = Image.fromarray((out * 255).astype(np.uint8))
                out = np.asarray(im.resize((width, height), Image.BILINEAR), np.float32) / 255.0
        self._cache[ck] = out
        return out

    def union_masks(self, keys: Sequence[str], height: int, width: int) -> np.ndarray:
        return np.stack([self._load(k, height, width) for k in keys])


def build_mask_provider(cfg, device=None) -> MaskProvider | None:
    """The provider ``cfg.mask_provider`` names: None for 'none' (no mask in
    the batch), :class:`PrecomputedMaskProvider` for 'precomputed', the live
    :class:`~mdn_sfm_tpu_torch.masks.maskrcnn.MaskRCNNProvider` on ``device``
    for 'maskrcnn'."""
    if cfg.mask_provider == "none":
        return None
    if cfg.mask_provider == "precomputed":
        return PrecomputedMaskProvider(cfg.mask_dir)
    if cfg.mask_provider == "maskrcnn":
        from .maskrcnn import MaskRCNNProvider

        return MaskRCNNProvider(cfg, device)
    raise ValueError(f"unknown mask provider {cfg.mask_provider!r}")
