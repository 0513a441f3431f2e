"""On-device augmentation — the port of ``mdn_sfm_tpu.data.augment``
(``augment_batch`` and ``eval_preprocess``).

Reference semantics kept as the JAX package keeps them:
* ColorJitter is a no-op as shipped (the reference's theta=1), so there is none.
* Horizontal flip p=0.5 with cx ← W − cx, folded into the x-resample.
* Zoom-crop ≤ 1.15 with continuous scales and offsets, as two separable
  interpolation products, with the K update.
* Normalize with mean 0.45 / std 0.225; scales 1..3 are 2×2 box averages
  (an exact ×½ bilinear resample without antialiasing) with K/2ˢ.

torch's generators cannot reproduce ``jax.random``, so the per-sample draws
(flip, scale_xy, offset_xy) can be given explicitly; a test feeds in JAX's.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..config import Config
from ..geometry import invert_intrinsics

Tensor = torch.Tensor

MEAN = 0.45
STD = 0.225
MAX_ZOOM = 1.15


def draw_augment(
    batch_size: int, height: int, width: int, generator: torch.Generator
) -> dict[str, Tensor]:
    """Per-sample flip (B,) bool, scale_xy (B, 2) in [1, 1.15) and offset_xy
    (B, 2) in [0, (scale−1)·(W, H)), drawn on the generator's device."""
    dev = generator.device
    flip = torch.rand(batch_size, generator=generator, device=dev) < 0.5
    scale_xy = 1.0 + (MAX_ZOOM - 1.0) * torch.rand(batch_size, 2, generator=generator, device=dev)
    max_off = torch.stack([width * scale_xy[:, 0] - width, height * scale_xy[:, 1] - height], -1)
    offset_xy = torch.rand(batch_size, 2, generator=generator, device=dev) * max_off
    return {"flip": flip, "scale_xy": scale_xy, "offset_xy": offset_xy}


def _interp_matrix(n: int, coords: Tensor) -> Tensor:
    """(B, n_out) continuous input coordinates → (B, n_out, n) linear
    interpolation weights W with out = W @ in (border clamped)."""
    x0 = torch.floor(coords)
    f = coords - x0
    i0 = x0.long().clamp(0, n - 1)
    i1 = (x0.long() + 1).clamp(0, n - 1)
    m = torch.zeros(coords.shape + (n,), dtype=torch.float32, device=coords.device)
    m.scatter_add_(-1, i0[..., None], (1.0 - f)[..., None])
    m.scatter_add_(-1, i1[..., None], f[..., None])
    return m


def augment_batch(
    cfg: Config,
    colors_u8: Tensor,
    K: Tensor,
    draws: Mapping[str, Tensor] | None = None,
    generator: torch.Generator | None = None,
    train: bool = True,
) -> tuple[dict, dict, Tensor]:
    """Augmentation + pyramid on the tensors' device.

    Args:
        colors_u8: (B, F, H, W, 3) uint8 frames, frame order == cfg.frame_ids.
        K: (B, 4, 4) intrinsics already rescaled to (W, H).
        draws: optional explicit per-sample draws {flip, scale_xy, offset_xy}
            (see :func:`draw_augment`); drawn from ``generator`` when None.
        train: apply the random flip/zoom-crop (False: normalization only).
    Returns:
        (colors, inv_Ks, raw0): colors {(frame_id, scale): (B, Hs, Ws, 3)
        normalized float32}, inv_Ks {scale: (B, 4, 4)}, raw0 the (B, H, W, 3)
        unnormalized [0, 1] scale-0 target.
    """
    b, f, h, w, _ = colors_u8.shape
    if f != len(cfg.frame_ids):
        raise ValueError(f"{f} frames given, cfg.frame_ids has {len(cfg.frame_ids)}")
    dev = colors_u8.device
    x = colors_u8.float() / 255.0
    K = K.float().clone()

    if train and not cfg.disable_augment:
        if draws is None:
            if generator is None:
                raise ValueError("augment_batch needs draws or a generator")
            draws = draw_augment(b, h, w, generator)
        flip = draws["flip"].to(dev).bool()
        scale_xy = draws["scale_xy"].to(dev).float()
        offset_xy = draws["offset_xy"].to(dev).float()

        K[:, 0, 2] = torch.where(flip, w - K[:, 0, 2], K[:, 0, 2])

        # output pixel (i, j) samples the (flipped) input at
        # ((j+ox+.5)/sx−.5, (i+oy+.5)/sy−.5): resize-to-(h·sy, w·sx) + crop
        ar_w = torch.arange(w, device=dev, dtype=torch.float32)[None]
        ar_h = torch.arange(h, device=dev, dtype=torch.float32)[None]
        in_x = (ar_w + offset_xy[:, 0:1] + 0.5) / scale_xy[:, 0:1] - 0.5
        in_y = (ar_h + offset_xy[:, 1:2] + 0.5) / scale_xy[:, 1:2] - 0.5
        in_x = torch.where(flip[:, None], (w - 1) - in_x, in_x)
        Wx = _interp_matrix(w, in_x)  # (B, W, W)
        Wy = _interp_matrix(h, in_y)  # (B, H, H)
        x = torch.einsum("bih,bfhwc->bfiwc", Wy, x)
        x = torch.einsum("bjw,bfiwc->bfijc", Wx, x)

        K[:, 0, :] = K[:, 0, :] * scale_xy[:, 0:1]
        K[:, 1, :] = K[:, 1, :] * scale_xy[:, 1:2]
        K[:, 0, 2] = K[:, 0, 2] - offset_xy[:, 0]
        K[:, 1, 2] = K[:, 1, 2] - offset_xy[:, 1]

    raw0 = x[:, 0]
    normalized = (x - MEAN) / STD

    num_scales = max(cfg.scales) + 1
    per_scale = [normalized]
    for _ in range(1, num_scales):
        prev = per_scale[-1]
        _, _, hs, ws, c = prev.shape
        # NHWC viewed as channels-last NCHW: the pool reads it in place
        down = F.avg_pool2d(prev.reshape(b * f, hs, ws, c).permute(0, 3, 1, 2), 2)
        per_scale.append(down.permute(0, 2, 3, 1).reshape(b, f, hs // 2, ws // 2, c))

    colors: dict = {}
    inv_Ks: dict = {}
    for s in range(num_scales):
        Ks = K
        if s:
            Ks = K.clone()
            Ks[:, 0, :] = Ks[:, 0, :] * (1.0 / 2**s)
            Ks[:, 1, :] = Ks[:, 1, :] * (1.0 / 2**s)
        inv_Ks[s] = invert_intrinsics(Ks)
        for fi, frame_id in enumerate(cfg.frame_ids):
            colors[(frame_id, s)] = per_scale[s][:, fi]

    return colors, inv_Ks, raw0


def eval_preprocess(colors_u8: Tensor) -> Tensor:
    """Normalize eval images: /255, mean 0.45, std 0.225, in float32."""
    return (colors_u8.float() / 255.0 - MEAN) / STD
