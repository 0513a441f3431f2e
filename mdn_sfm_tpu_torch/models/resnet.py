"""ResNet multi-image encoder — the port of ``mdn_sfm_tpu.models.resnet``.

torchvision-named trunk (conv1/bn1/layer{L}.{b}.*/downsample.{0,1}) widened
to stacked input frames, returning the 5-level pyramid [64, 64, 128, 256, 512]
(or ×4 for the bottleneck depths) at strides /2 … /32. NCHW.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import kaiming_out_

_STAGES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
_BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}

# flax BatchNorm(momentum=0.9) keeps 0.9 of the old average and adds 0.1 of
# the batch's statistic
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.Module):
    """BatchNorm with the reference's parameter names (weight, bias,
    running_mean, running_var) and no ``num_batches_tracked`` counter, so a
    state dict converted from Flax loads with ``strict=True``.

    In train mode it normalizes with the batch's statistics and updates the
    running averages as Flax's ``BatchNorm`` does: with the *biased* batch
    variance (``F.batch_norm`` would add the unbiased one, n/(n−1) larger).
    While ``replay`` is set (the recompute of a rematerialized forward) it
    normalizes with the batch's statistics and leaves the averages as the
    first forward left them."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.replay = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, BN_EPS)
        # momentum 1 writes the batch's mean and unbiased variance into
        # these two, in the same kernel that normalizes (a replay makes the
        # same call, so it saves the same tensors for backward)
        mean, var = torch.zeros_like(self.running_mean), torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, BN_EPS)
        if self.replay:
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM * (n - 1) / n)
        return y


def _conv(cin: int, cout: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3×3-BN-ReLU-3×3-BN + skip."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(_conv(cin, features, 1, stride), BatchNorm2d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1×1-3×3(stride)-1×1 with 4× expansion."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * 4
        self.conv1 = _conv(cin, features, 1, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, out_ch, 1, 1)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Sequential(_conv(cin, out_ch, 1, stride), BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """The torchvision-named trunk: 7×7/2 stem, 3×3/2 max-pool, 4 stages."""

    def __init__(self, num_layers: int = 18, in_ch: int = 6):
        super().__init__()
        if num_layers not in _STAGES:
            raise ValueError(f"{num_layers} is not a supported resnet depth")
        block = Bottleneck if _BOTTLENECK[num_layers] else BasicBlock
        self.conv1 = nn.Conv2d(in_ch, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), _STAGES[num_layers])):
            stride = 1 if stage == 0 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(cin, width, stride if b == 0 else 1))
                cin = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        features = [x]
        # max-pool pads with -inf, like the JAX stem
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            features.append(x)
        return features


class ResNetEncoder(nn.Module):
    """Multi-image ResNet encoder returning the 5-level pyramid; the trunk is
    nested as ``.encoder`` like the reference's ResnetEncoder."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 2):
        super().__init__()
        self.num_ch_enc = (64, 256, 512, 1024, 2048) if num_layers > 34 else (64, 64, 128, 256, 512)
        self.encoder = ResNet(num_layers, 3 * num_input_images)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.encoder(x)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                kaiming_out_(m.weight, generator)
            elif isinstance(m, BatchNorm2d):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
