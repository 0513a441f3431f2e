"""SE(3) and epipolar geometry on tensors — the port of ``mdn_sfm_tpu.geometry``.

NHWC image layout at every public function, like the JAX package, with
pixel coordinates (x=column, y=row). Everything here runs in float32
whatever the conv compute dtype. The 3×3 products are written out as
elementwise sums, so they stay full float32 on the card whatever the TF32
settings say.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .utils import divisor

Tensor = torch.Tensor


def _mm3(a: Tensor, b: Tensor) -> Tensor:
    """Batched (…, 3, 3) @ (…, 3, 3) as elementwise products + sums (full f32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


# ----------------------------------------------------------------- rotations


def rot_from_axisangle(vec: Tensor) -> Tensor:
    """Axis-angle (B, 3) → rotation matrix (B, 3, 3) via Rodrigues' formula,
    with the 1e-7 axis regularizer."""
    vec = vec.float()
    # gradient-safe angle: sqrt(Σv² + 1e-14) has a finite gradient at 0 and
    # keeps the f32 forward equal to the plain norm there
    angle = torch.sqrt((vec * vec).sum(-1, keepdim=True) + 1e-14)  # (B, 1)
    axis = vec / (angle + 1e-7)

    ca = torch.cos(angle)[..., None]  # (B, 1, 1)
    sa = torch.sin(angle)[..., None]
    C = 1.0 - ca

    x = axis[..., 0:1, None]
    y = axis[..., 1:2, None]
    z = axis[..., 2:3, None]

    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC

    row0 = torch.cat([x * xC + ca, xyC - zs, zxC + ys], -1)
    row1 = torch.cat([xyC + zs, y * yC + ca, yzC - xs], -1)
    row2 = torch.cat([zxC - ys, yzC + xs, z * zC + ca], -1)
    return torch.cat([row0, row1, row2], -2)  # (B, 3, 3)


def transformation_from_parameters(
    axisangle: Tensor, translation: Tensor, invert: bool = False
) -> Tensor:
    """(axis-angle, translation), each (B, 1, 1, 3) or (B, 3) → (B, 4, 4):
    T(t)·R, or R⁻¹·T(−t) when ``invert``."""
    aa = axisangle.reshape(axisangle.shape[0], 3)
    t = translation.reshape(translation.shape[0], 3).float()

    R3 = rot_from_axisangle(aa)
    if invert:
        R3 = R3.transpose(-1, -2)
        tcol = (R3 * (-t)[:, None, :]).sum(-1)
    else:
        tcol = t

    b = R3.shape[0]
    M = torch.zeros((b, 4, 4), dtype=torch.float32, device=R3.device)
    M[:, :3, :3] = R3
    M[:, :3, 3] = tcol
    M[:, 3, 3] = 1.0
    return M


# ------------------------------------------------------------- pixel grids


@functools.lru_cache(maxsize=64)
def _pixel_coords_np(height: int, width: int) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    return np.stack([xs, ys], axis=-1).astype(np.float32)  # (H, W, 2)


def pixel_coords(height: int, width: int, device: torch.device | str = "cpu") -> Tensor:
    """(H, W, 2) grid of (x, y) pixel coordinates (cached per device; read-only)."""
    return _on_device(_pixel_coords_np, (height, width), torch.device(device))


@functools.lru_cache(maxsize=128)
def _on_device(make, args: tuple, device: torch.device) -> Tensor:
    """A constant table built in numpy, copied to ``device`` once."""
    return torch.from_numpy(make(*args)).to(device)


def _scale_factor_np(height: int, width: int) -> np.ndarray:
    return np.array([width, height], np.float32)


def scale_factor(height: int, width: int, device: torch.device | str = "cpu") -> Tensor:
    """(2,) = [W, H]: converts the networks' normalized flow to pixel flow
    (cached per device like the other constants, so a step copies nothing to
    the card; read-only)."""
    return _on_device(_scale_factor_np, (height, width), torch.device(device))


# ----------------------------------------------------------- epipolar maps


def skew(t: Tensor) -> Tensor:
    """Skew-symmetric cross-product matrix of t (B, 3) → (B, 3, 3)."""
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], -1),
            torch.stack([t[..., 2], z, -t[..., 0]], -1),
            torch.stack([-t[..., 1], t[..., 0], z], -1),
        ],
        -2,
    )


def fundamental_matrix(inv_K: Tensor, rotation: Tensor, translation: Tensor) -> Tensor:
    """F = inv_Kᵀ · [t]ₓ · R · inv_K, batched (B, 3, 3), in full float32."""
    E = _mm3(skew(translation.float()), rotation.float())
    inv_K = inv_K.float()
    return _mm3(inv_K.transpose(-1, -2), _mm3(E, inv_K))


def epipolar_residual(
    flow: Tensor, inv_K: Tensor, rotation: Tensor, translation: Tensor
) -> Tensor:
    """Per-pixel signed epipolar residual (distance of p2 to the epipolar
    line F·p1), with p1 = (x, y, 1) and p2 = p1 + flow.

    Args:
        flow:        (B, H, W, 2) optical flow in PIXELS
        inv_K:       (B, 3, 3) or (B, 4, 4) (the 3×3 block is used)
        rotation:    (B, 3, 3); translation: (B, 3)
    Returns:
        (B, H, W) signed residual; callers take ``abs``.
    """
    _, h, w, _ = flow.shape
    Fm = fundamental_matrix(inv_K[..., :3, :3], rotation, translation)  # (B,3,3)

    pc = pixel_coords(h, w, flow.device)
    x1, y1 = pc[..., 0], pc[..., 1]

    flow = flow.float()
    x2 = x1[None] + flow[..., 0]
    y2 = y1[None] + flow[..., 1]

    def Fi(i: int) -> Tensor:
        return (
            Fm[:, i, 0, None, None] * x1[None]
            + Fm[:, i, 1, None, None] * y1[None]
            + Fm[:, i, 2, None, None]
        )

    f0, f1, f2 = Fi(0), Fi(1), Fi(2)
    num = f0 * x2 + f1 * y2 + f2  # (F·p1)·p2
    den = torch.sqrt(f0 * f0 + f1 * f1 + 1e-10) + 1e-10
    return num / den


def invert_intrinsics(K: Tensor) -> Tensor:
    """Closed-form inverse of batched (…, 4, 4) or (…, 3, 3) intrinsics
    [[fx, s, cx], [0, fy, cy], [0, 0, 1]] (block-diagonal with 1 for 4×4)."""
    K = K.float()
    fx = K[..., 0, 0]
    sk = K[..., 0, 1]
    cx = K[..., 0, 2]
    fy = K[..., 1, 1]
    cy = K[..., 1, 2]

    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    inv_fx = 1.0 / fx
    inv_fy = 1.0 / fy

    r0 = torch.stack([inv_fx, -sk * inv_fx * inv_fy, (sk * cy - cx * fy) * inv_fx * inv_fy], -1)
    r1 = torch.stack([zeros, inv_fy, -cy * inv_fy], -1)
    r2 = torch.stack([zeros, zeros, ones], -1)
    inv3 = torch.stack([r0, r1, r2], -2)

    if K.shape[-1] == 3:
        return inv3
    out = torch.zeros_like(K)
    out[..., :3, :3] = inv3
    out[..., 3, 3] = 1.0
    return out


# ----------------------------------------------------- sampling and warping


def bilinear_sample(img: Tensor, coords: Tensor, padding_mode: str = "zeros") -> Tensor:
    """Bilinear sampling at absolute pixel coordinates — what
    ``F.grid_sample(align_corners=True)`` computes, written as four gathers on
    the pixel coordinates themselves: grid_sample's normalize-and-back round
    trip moves a coordinate by an ulp of 2x/(W−1), about 1e-5 of a value.

    Args:
        img:    (B, H, W, C)
        coords: (B, H', W', 2) absolute (x, y) sample positions in pixels
        padding_mode: "zeros" (out-of-bounds taps contribute 0) or "border"
    Returns:
        (B, H', W', C)
    """
    b, h, w, c = img.shape
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat = img.reshape(b, h * w, c)

    def tap(xi: Tensor, yi: Tensor) -> Tensor:
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        idx = (yc * w + xc).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(xi.shape + (c,))
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            vals = vals * valid[..., None]
        return vals

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def inverse_warp(ref_img: Tensor, flow: Tensor, padding_mode: str = "zeros") -> tuple[Tensor, Tensor]:
    """Sample ``ref_img`` (B, H, W, C) at (pix + flow) and flag samples whose
    normalized grid coordinate lies in [-1, 1].

    Returns (warped (B, H, W, C), valid (B, H, W, 1) float mask)."""
    _, h, w, _ = ref_img.shape
    coords = pixel_coords(h, w, flow.device)[None] + flow.float()
    warped = bilinear_sample(ref_img, coords, padding_mode)
    gx = 2.0 * coords[..., 0] / divisor(coords, w - 1) - 1.0
    gy = 2.0 * coords[..., 1] / divisor(coords, h - 1) - 1.0
    valid = (torch.maximum(gx.abs(), gy.abs()) <= 1.0).to(ref_img.dtype)
    return warped, valid[..., None]


# -------------------------------------------------------------- resampling


def resize_bilinear(img: Tensor, height: int, width: int) -> Tensor:
    """Bilinear resize of NHWC (or HWC / HW) tensors: half-pixel, 2-tap,
    edge-clamped, NO antialias on downsampling (torch's tensor-mode
    ``interpolate``, which the reference's loss path uses)."""
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    x = x.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False, antialias=False)
    y = y.permute(0, 2, 3, 1).reshape(lead + (height, width, c))
    return y[..., 0] if squeeze else y


def _linear_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of ``jax.image.resize(method="linear")`` along one
    axis, in float32 as JAX computes them: a triangle kernel at the sample
    points (i + ½)·in/out − ½, widened by in/out when shrinking (the
    antialias), each column normalized to sum 1, zero where the sample point
    lies outside the input. The sample points are rounded to float32 once,
    as XLA's fused multiply-add computes them: at 640 → 1242 two roundings
    move a point by an ulp of its coordinate, a weight by 1.5e-5."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    # (i + ½)·inv_scale − ½ is exact in float64 (a 24-bit by 24-bit product)
    half = (np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
    sample_f = (half * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


def resize_linear(x: Tensor, shape: tuple[int, ...]) -> Tensor:
    """``jax.image.resize(x, shape, method="linear")``: separable linear
    resampling of every axis whose size changes, half-pixel centres, with
    the triangle kernel widened when shrinking (antialiased, unlike
    :func:`resize_bilinear`) and edge weights renormalized. Float32 on the
    tensor's device; the weights are cached per (size, device)."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} must have one size per axis of {tuple(x.shape)}")
    x = x.float()
    for d, n in enumerate(shape):
        if x.shape[d] != n:
            w = _on_device(_linear_weights_np, (x.shape[d], n), x.device)  # (n, in)
            x = torch.movedim(torch.movedim(x, d, -1) @ w.T, -1, d)
    return x.contiguous()


def upsample_nearest_2x(x: Tensor) -> Tensor:
    """Nearest ×2 upsample on NHWC."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, h * 2, w * 2, c)


# ---------------------------------------------------------- gaussian weight


@functools.lru_cache(maxsize=32)
def _gauss_distance_weight_np(
    height: int, width: int, num: int, sigma1: float, sigma2: float
) -> np.ndarray:
    h, w = height // num, width // num
    i = np.arange(h, dtype=np.float64)[:, None]
    j = np.arange(w, dtype=np.float64)[None, :]
    x_center, y_center = h // 2, w // 2
    a = (i - x_center) ** 2 / (sigma1 / num) ** 2
    b = (j - y_center) ** 2 / (sigma2 / num) ** 2
    factor = 1.0 / (2.0 * math.pi * sigma1 * sigma2)
    gauss = factor * np.exp(-(a + b) / 2.0)
    dist = 2e5 * (gauss.max() - gauss) + 5.0
    return dist.astype(np.float32)  # (h, w)


def gauss_distance_weight(
    height: int,
    width: int,
    num_scales: int,
    sigma1: float = 30.0,
    sigma2: float = 120.0,
    device: torch.device | str = "cpu",
) -> list[Tensor]:
    """Anisotropic center-weight maps for TG mode, one (H/2ˢ, W/2ˢ) map per
    scale, from the RAW sigmas (divided by 2ˢ per scale)."""
    return [
        _on_device(_gauss_distance_weight_np, (height, width, 2**s, sigma1, sigma2), torch.device(device))
        for s in range(num_scales)
    ]
