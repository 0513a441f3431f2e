"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- :func:`epipolar_abs_residual_maps` (and its one-map case
  :func:`epipolar_abs_residual`) — ``csrc/epipolar.cu``, the port of the
  Pallas kernel ``mdn_sfm_tpu/ops/pallas_epipolar.py::_kernel``.
- :mod:`.nms` (``nms.nms``) — ``csrc/nms.cu``, batched greedy NMS with a
  static output size, the counterpart of the XLA
  ``mdn_sfm_tpu/masks/maskrcnn.py::nms_fixed``.
- :mod:`.roi_align` (``roi_align.multilevel_roi_align``) —
  ``csrc/roi_align.cu``, ROIAlign-v2 over P2..P5, the counterpart of the XLA
  ``maskrcnn.py::multilevel_roi_align``.

The JAX package's ``ops/packed.py`` and ``ops/fused.py`` are TPU layout
devices (lane packing, a lhs-dilated up-conv) equal to the plain convolutions
the port's models run through cuDNN; they have no counterpart here.
"""

from .epipolar import (
    EpipolarMap,
    epipolar_abs_residual,
    epipolar_abs_residual_maps,
    epipolar_abs_residual_maps_reference,
    epipolar_abs_residual_reference,
)

__all__ = [
    "EpipolarMap",
    "epipolar_abs_residual",
    "epipolar_abs_residual_maps",
    "epipolar_abs_residual_maps_reference",
    "epipolar_abs_residual_reference",
]
