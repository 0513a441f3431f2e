"""|epipolar residual| maps: the CUDA kernel ``csrc/epipolar.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``mdn_sfm_tpu/ops/pallas_epipolar.py::_kernel``
(launched by ``epipolar_abs_residual_pallas``). :func:`epipolar_abs_residual_maps`
computes many maps in one launch — every map of a train step — each from the
networks' normalized flow, a pixel scale and the raw pose;
:func:`epipolar_abs_residual` is its one-map case. The tensors' device
chooses: CPU tensors take the plain version, CUDA tensors launch the kernel
or raise. The kernel's maps carry no gradient, so the loss takes it only
while flow and pose are frozen; when they train (``fine_tune_flow_motion``)
the config sends the loss to the plain version, with autograd.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from ..geometry import epipolar_residual
from . import _build

Tensor = torch.Tensor

_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PTR = ctypes.c_void_p

# the kernel's constants (csrc/epipolar.cu)
MAX_SEGMENTS = 16
THREADS = 256
VEC_PIXELS = 2
ITEMS = 4


class EpipolarMap(NamedTuple):
    """One map to compute: ``flow`` (B, H, W, 2) float32, any strides, whose
    u and v are multiplied by ``scale`` = (sx, sy) to give pixels ((W, H) for
    the networks' normalized flow, (1, 1) for pixel flow); ``inv_K`` (B, 3+,
    3+), ``rotation`` (B, 3, 3) and ``translation`` (B, 3), which may be views
    into a (B, 4, 4) pose (``T[:, :3, :3]``, ``T[:, :3, 3]``)."""

    flow: Tensor
    scale: tuple[float, float]
    inv_K: Tensor
    rotation: Tensor
    translation: Tensor


# ------------------------------------------------------------ plain version


def epipolar_abs_residual_reference(
    flow: Tensor, inv_K: Tensor, rotation: Tensor, translation: Tensor
) -> Tensor:
    """Plain version: ``|geometry.epipolar_residual(...)|``, (B, H, W) f32."""
    return epipolar_residual(flow, inv_K, rotation, translation).abs()


def _to_pixels(flow: Tensor, scale: tuple[float, float]) -> Tensor:
    """``flow · [sx, sy]`` in float32, as the loss's ``flow · scale_factor``
    rounds it, with no host-to-device copy."""
    flow = flow.float()
    if tuple(scale) == (1.0, 1.0):
        return flow
    return torch.stack((flow[..., 0] * scale[0], flow[..., 1] * scale[1]), -1)


def epipolar_abs_residual_maps_reference(maps: Sequence[EpipolarMap]) -> list[Tensor]:
    """Plain version of :func:`epipolar_abs_residual_maps`, one map at a time."""
    return [
        epipolar_abs_residual_reference(_to_pixels(m.flow, m.scale), m.inv_K, m.rotation, m.translation)
        for m in maps
    ]


# ------------------------------------------------------- the segment table


class _Segment(ctypes.Structure):
    """``Segment`` of csrc/epipolar.cu, field for field."""

    _fields_ = [
        ("flow", _PTR), ("inv_K", _PTR), ("rot", _PTR), ("trans", _PTR),
        ("flow_stride", _I64 * 4), ("inv_K_stride", _I64 * 3), ("rot_stride", _I64 * 3),
        ("trans_stride", _I64 * 2), ("out_offset", _I64),
        ("scale_x", ctypes.c_float), ("scale_y", ctypes.c_float),
        ("height", _I32), ("width", _I32), ("vec", _I32),
        ("block0", _I32), ("blocks_per_image", _I32),
    ]


class _Table(ctypes.Structure):
    """``Table`` of csrc/epipolar.cu: the output, the segment count, the
    grid's block count and the segments."""

    _fields_ = [("out", _PTR), ("n", _I32), ("total_blocks", _I32), ("seg", _Segment * MAX_SEGMENTS)]


def vector_layout(flow: Tensor) -> bool:
    """Whether ``flow`` takes the kernel's float4 path: each pixel pair's
    (u, v, u, v) contiguous and 16-byte aligned — w-stride 2, c-stride 1,
    even W, row and image strides multiples of 4, a 16-byte-aligned base. The
    networks' channels-last flow is so, even as a deinterleaved view."""
    _, _, w, _ = flow.shape
    sb, sh, sw, sc = flow.stride()
    return (w % 2 == 0 and sc == 1 and sw == 2 and sh % 4 == 0 and sb % 4 == 0
            and flow.data_ptr() % 16 == 0)


def out_offsets(maps: Sequence[EpipolarMap]) -> tuple[list[int], int]:
    """Each map's offset in the one output buffer, and the buffer's length in
    floats. Each map starts 16-byte aligned, so the kernel's float2 stores
    are aligned."""
    offsets, total = [], 0
    for m in maps:
        b, h, w, _ = m.flow.shape
        offsets.append(total)
        total += -(-b * h * w // 4) * 4
    return offsets, total


def build_table(maps: Sequence[EpipolarMap], out: Tensor) -> _Table:
    """The kernel's argument: one segment per map, with its pointers,
    strides, scale, shape, vector flag, output offset and first block."""
    if not 1 <= len(maps) <= MAX_SEGMENTS:
        raise ValueError(f"the epipolar kernel takes 1 to {MAX_SEGMENTS} maps a launch, got {len(maps)}")
    offsets, _ = out_offsets(maps)
    table = _Table(out=out.data_ptr(), n=len(maps))
    block = 0
    for seg, m, off in zip(table.seg, maps, offsets):
        b, h, w, _ = m.flow.shape
        vec = vector_layout(m.flow)
        per_block = THREADS * ITEMS * (VEC_PIXELS if vec else 1)
        seg.flow, seg.inv_K = m.flow.data_ptr(), m.inv_K.data_ptr()
        seg.rot, seg.trans = m.rotation.data_ptr(), m.translation.data_ptr()
        seg.flow_stride[:] = m.flow.stride()
        seg.inv_K_stride[:] = m.inv_K.stride()
        seg.rot_stride[:] = m.rotation.stride()
        seg.trans_stride[:] = m.translation.stride()
        seg.out_offset = off
        seg.scale_x, seg.scale_y = m.scale
        seg.height, seg.width, seg.vec = h, w, vec
        seg.block0 = block
        seg.blocks_per_image = -(-(h * w) // per_block)
        block += b * seg.blocks_per_image
    if block >= 2**31:
        raise ValueError("too many blocks for one epipolar launch")
    table.total_blocks = block
    return table


# ----------------------------------------------------------------- kernel


def _kernel_fn():
    fn = _build.load("epipolar").epipolar_abs_residual_maps_f32
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR]
        fn.restype = ctypes.c_int
    return fn


def launch(table: _Table, device: torch.device) -> None:
    """The bare kernel launch on ``device``'s current stream, from a table
    that :func:`build_table` made. The wrapper below checks its inputs and
    builds the table; this is what a timing of the kernel alone calls."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn()(ctypes.addressof(table), stream)
    if err != 0:
        raise RuntimeError(f"epipolar kernel launch failed: CUDA error {err}")


def _device_of(maps: Sequence[EpipolarMap]) -> torch.device:
    """The one device that every tensor of every map lies on, or raise."""
    devices = {x.device for m in maps for x in (m.flow, m.inv_K, m.rotation, m.translation)}
    if len(devices) != 1:
        raise ValueError(f"every flow and pose tensor must be on one device, got {sorted(map(str, devices))}")
    return devices.pop()


def _check(maps: Sequence[EpipolarMap]) -> None:
    for m in maps:
        flow = m.flow
        if flow.ndim != 4 or flow.shape[-1] != 2 or flow.dtype != torch.float32:
            raise ValueError(f"flow must be (B, H, W, 2) float32, got {tuple(flow.shape)} {flow.dtype}")
        if torch.is_grad_enabled() and flow.requires_grad:
            raise ValueError("the epipolar kernel has no gradient; flow must not require grad")
        b = flow.shape[0]
        for name, x, ok in (
            ("inv_K", m.inv_K, m.inv_K.ndim == 3 and m.inv_K.shape[0] == b and min(m.inv_K.shape[1:]) >= 3),
            ("rotation", m.rotation, tuple(m.rotation.shape) == (b, 3, 3)),
            ("translation", m.translation, tuple(m.translation.shape) == (b, 3)),
        ):
            if x.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {x.dtype}")
            if not ok:
                raise ValueError(f"{name} of shape {tuple(x.shape)} does not fit a batch of {b}")


def epipolar_abs_residual_maps(maps: Sequence[EpipolarMap]) -> list[Tensor]:
    """|epipolar residual| maps, one (B, H, W) float32 map per entry of
    ``maps`` (at most :data:`MAX_SEGMENTS`), all views of one buffer.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    for all maps (counted in ``epipolar_abs_residual_maps.launches``, the
    maps in ``.maps``) or raise. Every tensor of every map must lie on one
    device; on the card they must be float32.
    """
    maps = list(maps)
    if not 1 <= len(maps) <= MAX_SEGMENTS:
        raise ValueError(f"the epipolar kernel takes 1 to {MAX_SEGMENTS} maps a launch, got {len(maps)}")
    device = _device_of(maps)
    if device.type == "cpu":
        return epipolar_abs_residual_maps_reference(maps)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    _check(maps)
    offsets, total = out_offsets(maps)
    out = torch.empty(total, dtype=torch.float32, device=device)
    table = build_table(maps, out)
    if table.total_blocks:
        launch(table, device)
        epipolar_abs_residual_maps.launches += 1
        epipolar_abs_residual_maps.maps += len(maps)
    views = []
    for m, o in zip(maps, offsets):
        b, h, w, _ = m.flow.shape
        views.append(out[o:o + b * h * w].view(b, h, w))
    return views


epipolar_abs_residual_maps.launches = 0
epipolar_abs_residual_maps.maps = 0


def epipolar_abs_residual(
    flow: Tensor, inv_K: Tensor, rotation: Tensor, translation: Tensor
) -> Tensor:
    """|epipolar residual| map of one pixel flow, (B, H, W) float32: the
    one-map case of :func:`epipolar_abs_residual_maps`, with scale (1, 1).

    Args:
        flow: (B, H, W, 2) float32 pixel flow; any strides (a permuted view
            of NCHW flow is read in place).
        inv_K: (B, 3+, 3+); rotation (B, 3, 3); translation (B, 3); on the
            flow's device, and float32 on the card.
    """
    return epipolar_abs_residual_maps([EpipolarMap(flow, (1.0, 1.0), inv_K, rotation, translation)])[0]
