"""FlowNet — 2-frame ResNet encoder + top-down flow decoder, the port of
``mdn_sfm_tpu.models.flow_net`` (its unpacked path: the JAX package's packed
and fused stages are TPU layout devices with the same math).

- flow at scales 0..3 in NORMALIZED image units (multiply by
  ``geometry.scale_factor`` for pixels), scaled by
  flow_scale = relu(0.1 − 1e-3) + 1e-3, in float32;
- decoder features [d0, d1, d2, d3, d4, enc4] with channels
  (16, 32, 64, 128, 256, 512) — MobileDecoder's input contract.
NCHW in and out.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .layers import Conv3x3, ConvBlock, upsample_nearest_2x, xavier_conv_
from .resnet import ResNetEncoder

SCALE_FLOW = 0.1
CONSTRAINT_MIN = 1e-3

NUM_CH_DEC = (16, 32, 64, 128, 256)


def _constrained(scale: float) -> float:
    """relu(s − 1e-3) + 1e-3 evaluated in float32, as the JAX package does."""
    s = np.maximum(np.float32(scale) - np.float32(CONSTRAINT_MIN), np.float32(0.0))
    return float(s + np.float32(CONSTRAINT_MIN))


class FlowDecoder(nn.Module):
    """Per level: upsample ×2 → ConvBlock → skip-concat → ConvBlock; 2-channel
    flow heads at 4 scales. ``flow_net`` index layout: 0..9 are upconv_{4..0}
    _{0,1}, 10 + s is the scale-s head (the reference's state-dict names)."""

    def __init__(
        self,
        num_ch_enc: tuple[int, ...] = (64, 64, 128, 256, 512),
        scales: tuple[int, ...] = (0, 1, 2, 3),
        use_elu: bool = True,
    ):
        super().__init__()
        self.scales = tuple(scales)
        self.flow_scale = _constrained(SCALE_FLOW)
        mods = []
        for i in range(4, -1, -1):
            cin0 = num_ch_enc[-1] if i == 4 else NUM_CH_DEC[i + 1]
            mods.append(ConvBlock(cin0, NUM_CH_DEC[i], use_elu))
            cin1 = NUM_CH_DEC[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            mods.append(ConvBlock(cin1, NUM_CH_DEC[i], use_elu))
        for s in range(4):
            mods.append(Conv3x3(NUM_CH_DEC[s], 2))
        self.flow_net = nn.ModuleList(mods)

    def forward(self, input_features: list[torch.Tensor]) -> tuple[dict[int, torch.Tensor], list[torch.Tensor]]:
        outputs: dict[int, torch.Tensor] = {}
        x = input_features[-1]
        dec_features = [x]
        for i in range(4, -1, -1):
            x = self.flow_net[(4 - i) * 2](upsample_nearest_2x(x))
            if i > 0:
                x = torch.cat([x, input_features[i - 1].to(x.dtype)], 1)
            x = self.flow_net[(4 - i) * 2 + 1](x)
            dec_features.append(x)
            if i in self.scales:
                outputs[i] = self.flow_scale * self.flow_net[10 + i](x).float()
        return outputs, dec_features[::-1]

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                xavier_conv_(m, generator)


class FlowNet(nn.Module):
    """``forward(img1, img2)`` (NCHW) → ({scale: flow (B, 2, Hs, Ws)},
    decoder features)."""

    def __init__(self, num_layers: int = 18, use_elu: bool = True, scales: tuple[int, ...] = (0, 1, 2, 3)):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, num_input_images=2)
        self.decoder = FlowDecoder(self.encoder.num_ch_enc, scales, use_elu)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        return self.decoder(self.encoder(torch.cat([img1, img2], 1)))

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
