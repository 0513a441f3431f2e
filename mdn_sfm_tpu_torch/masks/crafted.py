"""A hand-set Mask R-CNN that detects bright regions: the port's own copy of
the JAX package's test fixture ``craft_brightness_detector``, written
directly as the port's :class:`~.maskrcnn.MaskRCNN` state dict
(detectron2's keys and layouts).

The rehearsal's ``maskrcnn@N`` rows (``python -m
mdn_sfm_tpu_torch.synthetic_e2e``) supervise DS/DC with it on the bright
synthetic world. Its features are the local mean brightness at every
resolution, so any disagreement between inference resolutions is the
pipeline's (anchor coverage, NMS budget, the 28×28 masks, paste), not the
features'. Wiring (every other weight zero, every BN the identity):

- stem conv1: channel 0 = the mean over the 7×7×3 window;
- res{2..5}.0 shortcut: a strided 1×1 pass-through of channel 0 (the main
  paths are zero, so the blocks subsample);
- FPN lateral/output: pass-through, the output scaled by 1/(levels summed
  top-down), so every P level carries about the same brightness;
- RPN: objectness = 0.1·brightness − 7;
- box head: fc1 unit 0 = the ROI's mean brightness, class-0 logit =
  0.1·unit0 − 4 against a background logit of 0; box deltas zero;
- mask head: predictor logit = 0.1·brightness − 7 per pixel.
"""

from __future__ import annotations

import torch

from ..models.resnet import BatchNorm2d

# channel 0 summed top-down into each FPN level: P2 holds 4 levels, P5 one
_TOP_DOWN_LEVELS = {2: 4.0, 3: 3.0, 4: 2.0, 5: 1.0}


@torch.no_grad()
def brightness_detector_state_dict() -> dict[str, torch.Tensor]:
    """The brightness detector's weights: a :class:`~.maskrcnn.MaskRCNN`
    state dict, float32 on the CPU (``MaskRCNNProvider(..., weights=...)``
    or ``load_state_dict`` take it)."""
    from .maskrcnn import MaskRCNN

    with torch.device("meta"):
        model = MaskRCNN()  # the keys and shapes only
    sd = {k: torch.zeros(v.shape, dtype=torch.float32) for k, v in model.state_dict().items()}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):  # the identity
            sd[f"{name}.weight"].fill_(1.0)
            sd[f"{name}.running_var"].fill_(1.0)

    bu = "backbone.bottom_up"
    sd[f"{bu}.stem.conv1.weight"][0] = 1.0 / (7 * 7 * 3)
    for stage in (2, 3, 4, 5):
        sd[f"{bu}.res{stage}.0.shortcut.weight"][0, 0, 0, 0] = 1.0
    for i, n in _TOP_DOWN_LEVELS.items():
        sd[f"backbone.fpn_lateral{i}.weight"][0, 0, 0, 0] = 1.0
        sd[f"backbone.fpn_output{i}.weight"][0, 0, 1, 1] = 1.0 / n

    rpn = "proposal_generator.rpn_head"
    sd[f"{rpn}.conv.weight"][0, 0, 1, 1] = 1.0
    sd[f"{rpn}.objectness_logits.weight"][:, 0, 0, 0] = 0.1
    sd[f"{rpn}.objectness_logits.bias"][:] = -7.0

    sd["roi_heads.box_head.fc1.weight"][0, 0:49] = 1.0 / 49.0  # NCHW-flat: channel 0 is 0..48
    sd["roi_heads.box_head.fc2.weight"][0, 0] = 1.0
    sd["roi_heads.box_predictor.cls_score.weight"][0, 0] = 0.1
    sd["roi_heads.box_predictor.cls_score.bias"][:-1] = -4.0  # the background logit stays 0

    mh = "roi_heads.mask_head"
    for i in (1, 2, 3, 4):
        sd[f"{mh}.mask_fcn{i}.weight"][0, 0, 1, 1] = 1.0
    sd[f"{mh}.deconv.weight"][0, 0] = 1.0
    sd[f"{mh}.predictor.weight"][:, 0, 0, 0] = 0.1
    sd[f"{mh}.predictor.bias"][:] = -7.0
    return sd
