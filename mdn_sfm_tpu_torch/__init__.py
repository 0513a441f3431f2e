"""MDN-SfM on PyTorch and CUDA — the port of :mod:`mdn_sfm_tpu` to an NVIDIA
Hopper GPU.

The JAX package stays the reference; this package mirrors its module layout
and names so each part has an obvious counterpart, and it imports neither
JAX nor anything of ``mdn_sfm_tpu`` (it keeps its own copies of the
framework-free pieces it needs).

Layout
------
- :mod:`mdn_sfm_tpu_torch.config`    — own copy of the dataclass config + mode enum
- :mod:`mdn_sfm_tpu_torch.geometry`  — SE(3) / epipolar geometry on NHWC tensors
- :mod:`mdn_sfm_tpu_torch.losses`    — the multi-scale loss, all five modes
- :mod:`mdn_sfm_tpu_torch.models`    — flow / pose / mobile-decoder ``nn.Module``s
- :mod:`mdn_sfm_tpu_torch.weights`   — Flax variable tree → the port's state dict
- :mod:`mdn_sfm_tpu_torch.data`      — on-device augmentation, synthetic batches
- :mod:`mdn_sfm_tpu_torch.ops`       — hand-written CUDA kernels and their plain versions
- :mod:`mdn_sfm_tpu_torch.training`  — the train step (frozen flow/pose, Adam on the decoder)
- :mod:`mdn_sfm_tpu_torch.train`     — ``python -m mdn_sfm_tpu_torch.train --synthetic``
- ``evaluate_{mix,mask,flow,pose}``, ``reproduce_readme_table`` — the eval CLIs
- :mod:`mdn_sfm_tpu_torch.masks`     — DS/DC instance masks: PNG providers, the Mask R-CNN R50-FPN
- ``precompute_masks`` — ``python -m mdn_sfm_tpu_torch.precompute_masks`` (1024-edge union PNGs)

Public geometry and loss functions keep the JAX package's NHWC layout (flow
is ``(B, H, W, 2)``); the ``nn.Module``s take and return NCHW tensors.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
