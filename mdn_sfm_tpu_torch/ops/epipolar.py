"""|epipolar residual| map: the CUDA kernel ``csrc/epipolar.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``mdn_sfm_tpu/ops/pallas_epipolar.py::_kernel``
(launched by ``epipolar_abs_residual_pallas``). The tensor's device chooses:
a CPU tensor takes :func:`epipolar_abs_residual_reference`, a CUDA tensor
launches the kernel or raises. The map carries no gradient, so it serves the
loss only while flow and pose are frozen.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry import epipolar_residual, fundamental_matrix
from . import _build

Tensor = torch.Tensor

_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p


def epipolar_abs_residual_reference(
    flow: Tensor, inv_K: Tensor, rotation: Tensor, translation: Tensor
) -> Tensor:
    """Plain version: ``|geometry.epipolar_residual(...)|``, (B, H, W) f32."""
    return epipolar_residual(flow, inv_K, rotation, translation).abs()


def _kernel_fn():
    fn = _build.load("epipolar").epipolar_abs_residual_f32
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, _I64, _I64, _I64, _I64, _PTR,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _PTR]
        fn.restype = ctypes.c_int
    return fn


def epipolar_abs_residual(
    flow: Tensor, inv_K: Tensor, rotation: Tensor, translation: Tensor
) -> Tensor:
    """|epipolar residual| map, (B, H, W) float32.

    Args:
        flow: (B, H, W, 2) float32 pixel flow; any strides (a permuted view
            of NCHW flow is read in place).
        inv_K: (B, 3+, 3+); rotation (B, 3, 3); translation (B, 3); on the
            card they must be float32 on flow's device.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (counted in ``epipolar_abs_residual.launches``) or raises.
    """
    if flow.device.type == "cpu":
        return epipolar_abs_residual_reference(flow, inv_K, rotation, translation)
    if flow.device.type != "cuda":
        raise ValueError(f"unsupported device {flow.device}")
    if flow.ndim != 4 or flow.shape[-1] != 2 or flow.dtype != torch.float32:
        raise ValueError(f"flow must be (B, H, W, 2) float32, got {tuple(flow.shape)} {flow.dtype}")
    if torch.is_grad_enabled() and flow.requires_grad:
        raise ValueError("the epipolar kernel has no gradient; flow must not require grad")
    for name, x in (("inv_K", inv_K), ("rotation", rotation), ("translation", translation)):
        if x.dtype != torch.float32 or x.device != flow.device:
            raise ValueError(f"{name} must be float32 on {flow.device}, got {x.dtype} on {x.device}")
    b, h, w, _ = flow.shape
    F = fundamental_matrix(inv_K[..., :3, :3], rotation, translation).reshape(b, 9).contiguous()
    out = torch.empty((b, h, w), dtype=torch.float32, device=flow.device)
    launch(F, flow, out)
    epipolar_abs_residual.launches += 1
    return out


def launch(F: Tensor, flow: Tensor, out: Tensor) -> None:
    """The bare kernel launch on the current stream: F (B, 9) contiguous, flow
    (B, H, W, 2) and out (B, H, W) contiguous, all float32 on one card. The
    wrapper above checks its inputs and builds F; this is what a timing of
    the kernel alone calls."""
    b, h, w, _ = flow.shape
    sb, sh, sw, sc = flow.stride()
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(F.data_ptr(), flow.data_ptr(), sb, sh, sw, sc,
                           out.data_ptr(), b, h, w, stream)
    if err != 0:
        raise RuntimeError(f"epipolar kernel launch failed: CUDA error {err}")


epipolar_abs_residual.launches = 0
