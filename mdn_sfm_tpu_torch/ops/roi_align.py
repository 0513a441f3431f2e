"""Multilevel ROIAlign-v2 over P2..P5: the CUDA kernel ``csrc/roi_align.cu``
and its plain PyTorch version.

The counterpart of ``mdn_sfm_tpu/masks/maskrcnn.py::multilevel_roi_align``,
whose gather form ``multilevel_roi_align_gather`` and ``_roi_sample_box``
define the arithmetic, batched over images. Both versions assign each box
its FPN level, blend the aligned 4-tap bilinear taps of every sub-bin in
float32 (bf16 features are widened) in the JAX package's operation order,
average the sub-bins, and return the features' type. The tensors' device
chooses: CPU tensors take the plain version, CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..utils import divisor
from . import _build

Tensor = torch.Tensor

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int32

LEVEL_STRIDES = (4.0, 8.0, 16.0, 32.0)
# the kernel's limit (csrc/roi_align.cu kMaxSamples): sample rows a box, the
# taps of which its block keeps in shared memory
MAX_SAMPLES = 128
# the plain version's working set: sample taps per chunk of boxes
_CHUNK_ELEMENTS = 1 << 23


class _Levels(ctypes.Structure):
    """``Levels`` of csrc/roi_align.cu, field for field."""

    _fields_ = [("feat", _PTR * 4), ("height", _I32 * 4), ("width", _I32 * 4)]


def assign_fpn_level(boxes: Tensor) -> Tensor:
    """FPN level of each box (..., 4): ⌊4 + log2(√area/224 + 1e-8)⌋ clamped
    to [2, 5], in float32 as the JAX package computes it; int64."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / divisor(area, 224.0) + 1e-8))
    return lvl.clamp(2, 5).long()


def _sample_coords(lo: Tensor, hi: Tensor, out_size: int, sampling: int) -> Tensor:
    """(..., S·sampling) sub-bin centres along one axis, in ``_roi_sample_box``'s order."""
    n = out_size * sampling
    span = torch.clamp(hi - lo, min=1e-6)
    k = torch.arange(n, device=lo.device, dtype=torch.float32) + 0.5
    return lo[..., None] + k * span[..., None] / divisor(lo, n) - 0.5


def sample_taps(boxes: Tensor, level_hw: Sequence[tuple[int, int]], out_size: int, sampling: int = 2):
    """The bilinear taps of every sub-bin of every box, as the kernel takes
    them: (rows, wy, wx). ``rows`` holds the four taps' (N, R, n, n) indices
    (n = out_size·sampling) into the P2..P5 rows flattened image by image
    (ΣH·W of them; each box reads its own level's range, clipped to it);
    ``wy`` (N, R, n, 1, 1) and ``wx`` (N, R, 1, n, 1) are the blend weights."""
    dev = boxes.device
    offs = torch.tensor([0] + [h * w for h, w in level_hw[:3]], device=dev).cumsum(0)
    heights = torch.tensor([h for h, _ in level_hw], device=dev)
    widths = torch.tensor([w for _, w in level_hw], device=dev)
    strides = torch.tensor(LEVEL_STRIDES, device=dev)
    lvl = assign_fpn_level(boxes) - 2                                     # (N, R)
    b = boxes / strides[lvl][..., None]
    h_l, w_l, off_l = heights[lvl], widths[lvl], offs[lvl]
    ys = _sample_coords(b[..., 1], b[..., 3], out_size, sampling)       # (N, R, n)
    xs = _sample_coords(b[..., 0], b[..., 2], out_size, sampling)
    y0, x0 = torch.floor(ys), torch.floor(xs)

    def clip(v, size):
        return torch.minimum(torch.clamp(v.long(), min=0), size[..., None] - 1)

    ya, yb = clip(y0, h_l), clip(y0 + 1, h_l)
    xa, xb = clip(x0, w_l), clip(x0 + 1, w_l)

    def row(yi, xi):
        return off_l[..., None, None] + yi[..., :, None] * w_l[..., None, None] + xi[..., None, :]

    rows = (row(ya, xa), row(ya, xb), row(yb, xa), row(yb, xb))
    return rows, (ys - y0)[..., :, None, None], (xs - x0)[..., None, :, None]


def roi_align_reference(feats: Sequence[Tensor], boxes: Tensor, out_size: int, sampling: int = 2) -> Tensor:
    """Plain version of :func:`multilevel_roi_align` (any strides)."""
    n_img, n_box, _ = boxes.shape
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    flat = torch.cat([f.reshape(n_img, -1, c) for f in feats[:4]], 1).float()  # (N, ΣHW, C)
    (r00, r01, r10, r11), wy, wx = sample_taps(boxes, [(f.shape[1], f.shape[2]) for f in feats[:4]], out_size,
                                               sampling)
    images = torch.arange(n_img, device=boxes.device)[:, None, None, None]
    out = torch.empty(n_img, n_box, out_size, out_size, c, dtype=dtype, device=boxes.device)
    n = out_size * sampling
    chunk = max(1, _CHUNK_ELEMENTS // max(1, n_img * n * n * c))
    for r0 in range(0, n_box, chunk):
        s = slice(r0, r0 + chunk)

        def tap(rows):  # (N, r, n, n, C)
            return flat[images, rows[:, s]]

        wy_s, wx_s = wy[:, s], wx[:, s]
        v = (tap(r00) * (1 - wy_s) * (1 - wx_s) + tap(r01) * (1 - wy_s) * wx_s
             + tap(r10) * wy_s * (1 - wx_s) + tap(r11) * wy_s * wx_s)
        v = v.reshape(n_img, v.shape[1], out_size, sampling, out_size, sampling, c)
        acc = None
        for sy in range(sampling):
            for sx in range(sampling):
                acc = v[:, :, :, sy, :, sx] if acc is None else acc + v[:, :, :, sy, :, sx]
        out[:, s] = (acc / (sampling * sampling)).to(dtype)
    return out


def distinct_taps(boxes: Tensor, level_hw: Sequence[tuple[int, int]], out_size: int, sampling: int = 2) -> int:
    """How many distinct feature pixels (image, level, y, x) the boxes'
    taps touch: what a ROIAlign over these boxes must read, at least."""
    rows = torch.stack(sample_taps(boxes, level_hw, out_size, sampling)[0])  # (4, N, R, n, n)
    total = sum(h * w for h, w in level_hw)
    keyed = rows + total * torch.arange(boxes.shape[0], device=boxes.device)[None, :, None, None, None]
    return int(torch.unique(keyed).numel())


def _kernel_fn(dtype: torch.dtype):
    lib = _build.load("roi_align")
    fn = lib.roi_align_f32 if dtype == torch.float32 else lib.roi_align_bf16
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR, _PTR]
        fn.restype = ctypes.c_int
    return fn


def multilevel_roi_align(feats: Sequence[Tensor], boxes: Tensor, out_size: int, sampling: int = 2) -> Tensor:
    """ROIAlign-v2 (aligned) over P2..P5 with a per-box FPN level.

    Args:
        feats: P2..P5 (extra levels are ignored), each (N, H_l, W_l, C)
            channels-last, of one type: float32 or bfloat16.
        boxes: (N, R, 4) float32 XYXY in image coordinates.
        out_size: bins a side (7 for the box head, 14 for the mask head).
    Returns:
        (N, R, out_size, out_size, C) in the features' type.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    (counted in ``multilevel_roi_align.launches``) or raise. The kernel
    takes 16-byte vectors of channels where C and the levels' alignment
    allow, and single channels otherwise.
    """
    feats = list(feats[:4])
    if len(feats) != 4 or boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"need P2..P5 and (N, R, 4) boxes, got {len(feats)} levels and {tuple(boxes.shape)}")
    devices = {f.device for f in feats} | {boxes.device}
    if len(devices) != 1:
        raise ValueError(f"features and boxes must be on one device, got {sorted(map(str, devices))}")
    n_img, n_box, _ = boxes.shape
    c = feats[0].shape[-1]
    for f in feats:
        if f.ndim != 4 or f.shape[0] != n_img or f.shape[-1] != c or f.dtype != feats[0].dtype:
            raise ValueError(f"levels must be (N, H, W, C) of one type, got {tuple(f.shape)} {f.dtype}")
    if boxes.device.type == "cpu":
        return roi_align_reference(feats, boxes, out_size, sampling)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    dtype = feats[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or boxes.dtype != torch.float32:
        raise ValueError(f"the ROIAlign kernel takes float32 or bfloat16 features and float32 boxes, "
                         f"got {dtype} and {boxes.dtype}")
    if sampling < 1 or out_size * sampling > MAX_SAMPLES:
        raise ValueError(f"the ROIAlign kernel takes 1 to {MAX_SAMPLES} samples a side, "
                         f"got out_size {out_size} × sampling {sampling}")
    # the kernel indexes in int32 within an image's level and a box's output
    sizes = [f[0].numel() for f in feats] + [out_size * out_size * c]
    if max(sizes) >= 2**31 or n_img * n_box >= 2**31:
        raise ValueError(f"the ROIAlign kernel takes an image's level and a box's output under 2^31 elements "
                         f"and under 2^31 boxes, got {max(sizes)} and {n_img * n_box}")
    feats = [f.contiguous() for f in feats]
    boxes = boxes.contiguous()
    out = torch.empty(n_img, n_box, out_size, out_size, c, dtype=dtype, device=boxes.device)
    if out.numel():
        lv = _Levels()
        lv.feat[:] = [f.data_ptr() for f in feats]
        lv.height[:] = [f.shape[1] for f in feats]
        lv.width[:] = [f.shape[2] for f in feats]
        with torch.cuda.device(boxes.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel_fn(dtype)(ctypes.addressof(lv), boxes.data_ptr(), n_img, n_box, c, out_size, sampling,
                                    out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"ROIAlign kernel launch failed: CUDA error {err}")
        multilevel_roi_align.launches += 1
    return out


multilevel_roi_align.launches = 0
