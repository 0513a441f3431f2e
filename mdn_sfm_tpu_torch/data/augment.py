"""On-device augmentation — the port of ``mdn_sfm_tpu.data.augment``
(``augment_batch`` and ``eval_preprocess``).

Reference semantics kept as the JAX package keeps them:
* ColorJitter is a no-op as shipped (the reference's theta=1), so there is none.
* Horizontal flip p=0.5 with cx ← W − cx, folded into the x-resample.
* Zoom-crop ≤ 1.15 with continuous scales and offsets, as two separable
  2-tap resamples (rows, then columns), with the K update.
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
from ..utils import divisor

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


def _resample(x: Tensor, coords: Tensor, dim: int) -> Tensor:
    """2-tap linear resample of ``x`` (B, F, H, W, C) along ``dim`` (2: rows,
    3: columns) at per-sample continuous input coordinates ``coords`` (B,
    n_out), border clamped. Two gathers, two products and a sum, each its
    own elementwise op: it rounds alike on every device (a matrix product
    would add the taps in the library's order)."""
    n = x.shape[dim]
    x0 = torch.floor(coords)
    frac = coords - x0
    i0 = x0.long().clamp(0, n - 1)
    i1 = (x0.long() + 1).clamp(0, n - 1)
    view = [coords.shape[0], 1, 1, 1, 1]
    view[dim] = coords.shape[1]
    out_shape = list(x.shape)
    out_shape[dim] = coords.shape[1]

    def taps(i: Tensor) -> Tensor:
        return torch.gather(x, dim, i.view(view).expand(out_shape))

    w = frac.view(view)
    return taps(i0) * (1.0 - w) + taps(i1) * w


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
    x = colors_u8.float()
    x = x / divisor(x, 255.0)
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
        x = _resample(_resample(x, in_y, 2), in_x, 3)

        K[:, 0, :] = K[:, 0, :] * scale_xy[:, 0:1]
        K[:, 1, :] = K[:, 1, :] * scale_xy[:, 1:2]
        K[:, 0, 2] = K[:, 0, 2] - offset_xy[:, 0]
        K[:, 1, 2] = K[:, 1, 2] - offset_xy[:, 1]

    raw0 = x[:, 0]
    normalized = (x - MEAN) / divisor(x, STD)

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
    x = colors_u8.float()
    return (x / divisor(x, 255.0) - MEAN) / divisor(x, STD)
