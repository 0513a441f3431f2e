"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- :func:`epipolar_abs_residual_maps` (and its one-map case
  :func:`epipolar_abs_residual`) — ``csrc/epipolar.cu``, the port of the
  Pallas kernel ``mdn_sfm_tpu/ops/pallas_epipolar.py::_kernel``.

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
