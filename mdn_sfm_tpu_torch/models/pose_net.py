"""PoseNet — 2-frame ResNet encoder + conv pose head, the port of
``mdn_sfm_tpu.models.pose_net``.

Output: (axisangle, translation), each (B, 1, 1, 3) float32, scaled by
relu(0.01 − 1e-3) + 1e-3.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .flow_net import _constrained
from .layers import lecun_normal_
from .resnet import ResNetEncoder

SCALE_TRANSLATION = 0.01
SCALE_ROTATION = 0.01


class PoseDecoder(nn.Module):
    """squeeze 1×1 → two 3×3 stride-2 convs (padding 1) → 1×1 to 6 channels →
    spatial mean → scaled. ``pose_net`` indices 0..3 as in the reference."""

    def __init__(self, in_ch: int = 512, stride: int = 2, use_elu: bool = False):
        super().__init__()
        self.use_elu = use_elu
        self.pose_net = nn.ModuleList(
            [
                nn.Conv2d(in_ch, 256, 1),
                nn.Conv2d(256, 256, 3, stride, 1),
                nn.Conv2d(256, 256, 3, stride, 1),
                nn.Conv2d(256, 6, 1),
            ]
        )
        self.rot_scale = _constrained(SCALE_ROTATION)
        self.tr_scale = _constrained(SCALE_TRANSLATION)

    def forward(self, last_features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        nonlin = F.elu if self.use_elu else F.relu
        out = last_features
        for conv in self.pose_net[:3]:
            out = nonlin(conv(out))
        out = self.pose_net[3](out)
        out = out.float().mean((2, 3)).reshape(-1, 1, 1, 6)
        return self.rot_scale * out[..., :3], self.tr_scale * out[..., 3:]

    def init_weights(self, generator: torch.Generator) -> None:
        for conv in self.pose_net:
            lecun_normal_(conv.weight, generator)
            with torch.no_grad():
                conv.bias.zero_()


class PoseNet(nn.Module):
    """``forward(img1, img2)`` (NCHW) → (axisangle, translation)."""

    def __init__(self, num_layers: int = 18, use_elu: bool = False):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, num_input_images=2)
        self.decoder = PoseDecoder(self.encoder.num_ch_enc[-1], use_elu=use_elu)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor):
        return self.decoder(self.encoder(torch.cat([img1, img2], 1))[-1])

    def init_weights(self, generator: torch.Generator) -> None:
        self.encoder.init_weights(generator)
        self.decoder.init_weights(generator)
