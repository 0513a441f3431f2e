"""MobileDecoder — the TRAINABLE network, the port of
``mdn_sfm_tpu.models.mobile_decoder`` (its unpacked path).

Consumes FlowNet's decoder features [d0, d1, d2, d3, d4, enc4] (channels
16 … 512, NCHW) plus the pose broadcast over the bottleneck, concatenated as
[bottleneck, axisangle, translation], and emits float32 sigmoid mobile maps
(B, 1, H/2ˢ, W/2ˢ) at 4 scales.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .flow_net import NUM_CH_DEC
from .layers import Conv3x3, ConvBlock, upsample_nearest_2x, xavier_conv_


class MobileDecoder(nn.Module):
    """``mobile_net`` index layout: 0..9 are upconv_{4..0}_{0,1}, 10 + s is
    the scale-s head (the reference's state-dict names)."""

    def __init__(
        self,
        num_ch_enc: tuple[int, ...] = (16, 32, 64, 128, 256, 512),
        scales: tuple[int, ...] = (0, 1, 2, 3),
        use_elu: bool = True,
    ):
        super().__init__()
        self.scales = tuple(scales)
        mods = []
        for i in range(4, -1, -1):
            cin0 = num_ch_enc[-1] + 6 if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin0, NUM_CH_DEC[i], use_elu))
            mods.append(ConvBlock(NUM_CH_DEC[i] + num_ch_enc[i], NUM_CH_DEC[i], use_elu))
        for s in range(4):
            mods.append(Conv3x3(NUM_CH_DEC[s], 1))
        self.mobile_net = nn.ModuleList(mods)

    def forward(
        self, input_features: list[torch.Tensor], axisangle: torch.Tensor, translation: torch.Tensor
    ) -> dict[int, torch.Tensor]:
        bottleneck = input_features[-1]
        b, _, h, w = bottleneck.shape
        aa = axisangle.reshape(b, 3, 1, 1).expand(b, 3, h, w).to(bottleneck.dtype)
        t = translation.reshape(b, 3, 1, 1).expand(b, 3, h, w).to(bottleneck.dtype)
        x = torch.cat([bottleneck, aa, t], 1)

        outputs: dict[int, torch.Tensor] = {}
        for i in range(4, -1, -1):
            x = self.mobile_net[(4 - i) * 2](upsample_nearest_2x(x))
            x = torch.cat([x, input_features[i].to(x.dtype)], 1)
            x = self.mobile_net[(4 - i) * 2 + 1](x)
            if i in self.scales:
                outputs[i] = torch.sigmoid(self.mobile_net[10 + i](x).float())
        return outputs

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_conv_(m, generator)
