"""Instance-mask providers for the DS and DC modes — the port of
``mdn_sfm_tpu.masks``.

- :class:`NullMaskProvider` — all-zero masks.
- :class:`PrecomputedMaskProvider` — per-sample union-mask PNGs from disk
  (written by ``python -m mdn_sfm_tpu_torch.precompute_masks``).
- :mod:`.maskrcnn` — the Mask R-CNN R50-FPN inference graph, its detectron2
  weight import, the live :class:`~.maskrcnn.MaskRCNNProvider` and the
  GT-tooling :class:`~.maskrcnn.MaskRCNNBackend`.
"""

from .providers import MaskProvider, NullMaskProvider, PrecomputedMaskProvider, build_mask_provider

__all__ = [
    "MaskProvider",
    "NullMaskProvider",
    "PrecomputedMaskProvider",
    "build_mask_provider",
]
