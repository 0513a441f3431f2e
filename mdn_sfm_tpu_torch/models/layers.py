"""Shared conv building blocks and initializers — the port of
``mdn_sfm_tpu.models.layers``. NCHW ``nn.Module``s."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's truncated-normal variance scaling divides the std by the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor) -> tuple[int, int]:
    receptive = w[0, 0].numel()
    return w.shape[1] * receptive, w.shape[0] * receptive  # fan_in, fan_out


def variance_scaling_(w: torch.Tensor, scale: float, mode: str, generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, mode, "truncated_normal")`` on an OIHW weight."""
    fan_in, fan_out = _fans(w)
    std = math.sqrt(scale / (fan_in if mode == "fan_in" else fan_out)) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def kaiming_out_(w: torch.Tensor, generator: torch.Generator) -> None:
    """kaiming_normal(fan_out, relu) as the encoder initializes its convs."""
    variance_scaling_(w, 2.0, "fan_out", generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv kernel init."""
    variance_scaling_(w, 1.0, "fan_in", generator)


def xavier_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Xavier-uniform weight and zero bias, the decoder convs' init."""
    with torch.no_grad():
        nn.init.xavier_uniform_(conv.weight, generator=generator)
        if conv.bias is not None:
            conv.bias.zero_()


class Conv3x3(nn.Module):
    """Reflection-pad by 1, then a VALID 3×3 conv."""

    def __init__(self, in_ch: int, out_ch: int, use_refl: bool = True):
        super().__init__()
        self.pad_mode = "reflect" if use_refl else "constant"
        self.conv = nn.Conv2d(in_ch, out_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode=self.pad_mode))


class ConvBlock(nn.Module):
    """Conv3x3 followed by ELU or ReLU."""

    def __init__(self, in_ch: int, out_ch: int, use_elu: bool = True):
        super().__init__()
        self.use_elu = use_elu
        self.conv = Conv3x3(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.elu(x) if self.use_elu else F.relu(x)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
