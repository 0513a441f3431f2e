"""PyTorch models — counterparts of ``mdn_sfm_tpu.models``, NCHW ``nn.Module``s
whose state-dict names are the reference's (``checkpoints.export_pth``).

- :class:`ResNetEncoder` — 5-level pyramid [64, 64, 128, 256, 512] at /2 … /32
- :class:`FlowNet` — flow at 4 scales + decoder features [16 … 512]
- :class:`PoseNet` — axis-angle + translation, ×0.01
- :class:`MobileDecoder` — sigmoid mobile maps at 4 scales (the trained net)
"""

from .layers import Conv3x3, ConvBlock
from .resnet import ResNetEncoder
from .flow_net import FlowDecoder, FlowNet
from .pose_net import PoseDecoder, PoseNet
from .mobile_decoder import MobileDecoder

__all__ = [
    "Conv3x3",
    "ConvBlock",
    "ResNetEncoder",
    "FlowDecoder",
    "FlowNet",
    "PoseDecoder",
    "PoseNet",
    "MobileDecoder",
]
