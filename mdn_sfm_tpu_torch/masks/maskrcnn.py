"""Mask R-CNN R50-FPN inference — the port of ``mdn_sfm_tpu.masks.maskrcnn``,
the frozen detectron2 model (Cityscapes ``mask_rcnn_R_50_FPN`` config,
11-class KITTI weights) that supervises the DS and DC modes.

The graph is static-shape as in the JAX package (fixed proposal, candidate
and detection counts with validity masks), and batched over images where
the JAX package ``vmap``s one image:

  BGR caffe-normalized images → ResNet-50 (stride_in_1x1, frozen BN) → FPN
  P2..P6 → RPN head → per-level top-k + level-offset NMS → ROIAlign 7×7 →
  box head → class-offset NMS → ROIAlign 14×14 → mask head → 28×28 masks →
  paste (two f32 ``bmm``s).

NMS and ROIAlign go through the port's CUDA kernels on the card
(:mod:`mdn_sfm_tpu_torch.ops.nms`, :mod:`mdn_sfm_tpu_torch.ops.roi_align`);
the networks run in ``channels_last`` under bf16 autocast when ``dtype`` is
bf16. The modules' ``state_dict()`` keys are detectron2's own, so
``model_final_detectron2.pth`` loads with :func:`import_detectron2_pth`.
Top-k is a stable descending sort, so ties keep the lower index first, as
``jax.lax.top_k`` does.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.resnet import BatchNorm2d
from ..ops.nms import nms
from ..ops.roi_align import assign_fpn_level, multilevel_roi_align
from ..utils import divisor, resolve_device, use_full_f32

Tensor = torch.Tensor

# --- detectron2 Cityscapes mask_rcnn_R_50_FPN config + reference overrides
PIXEL_MEAN_BGR = (103.53, 116.28, 123.675)  # caffe2 means, std 1
MIN_SIZE_TEST = 1024
MAX_SIZE_TEST = 2048
ANCHOR_SIZES = (32, 64, 128, 256, 512)      # per FPN level P2..P6
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
RPN_PRE_NMS_TOPK = 1000
RPN_POST_NMS_TOPK = 1000
RPN_NMS_THRESH = 0.7
BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
ROI_SCORE_THRESH = 0.3
ROI_NMS_THRESH = 0.5
NUM_CLASSES = 11
MASK_RES = 28

# the fast proposal budget shared by the training-time provider and the
# GT-tooling backend's fast=True (ROIAlign precision is not part of it)
FAST_BUDGET = dict(pre_nms_topk=256, post_nms_topk=256, box_candidates=512)

__all__ = [
    "D2ResNet50", "FPN", "RPNHead", "BoxHead", "BoxPredictor", "MaskHead", "MaskRCNN", "Detections",
    "MaskRCNNBackend", "MaskRCNNProvider", "FAST_BUDGET", "anchors_for_level", "decode_boxes",
    "clip_boxes", "iou_matrix", "assign_fpn_level", "paste_masks", "paste_threshold_union_ready",
    "preprocess_np", "static_input_shape", "build_model_and_weights", "import_detectron2_pth",
    "import_detectron2_state_dict",
]


# ------------------------------------------------------------------ modules


class Conv2dNorm(nn.Conv2d):
    """A bias-free conv with a frozen BN child ``norm``: detectron2's
    ``<name>.weight`` + ``<name>.norm.*`` layout."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False)
        self.norm = BatchNorm2d(cout)

    def forward(self, x: Tensor) -> Tensor:
        return self.norm(super().forward(x))


class D2Bottleneck(nn.Module):
    """detectron2's caffe-style bottleneck: the stride on the first 1×1
    (``stride_in_1x1``), a ``shortcut`` projection where the shape changes."""

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = Conv2dNorm(cin, width, 1, stride)
        self.conv2 = Conv2dNorm(width, width, 3)
        self.conv3 = Conv2dNorm(width, width * 4, 1)
        self.shortcut = Conv2dNorm(cin, width * 4, 1, stride) if stride != 1 or cin != width * 4 else None

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.shortcut is None else self.shortcut(x)
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        return F.relu(self.conv3(out) + identity)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = Conv2dNorm(3, 64, 7, 2)

    def forward(self, x: Tensor) -> Tensor:
        # max_pool2d pads with -inf, as the JAX stem does
        return F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)


class D2ResNet50(nn.Module):
    """detectron2's ResNet-50 trunk → [C2, C3, C4, C5] at /4 … /32 (NCHW)."""

    def __init__(self):
        super().__init__()
        self.stem = _Stem()
        cin = 64
        for stage, (width, n_blocks) in enumerate(zip((64, 128, 256, 512), (3, 4, 6, 3))):
            blocks = []
            for b in range(n_blocks):
                blocks.append(D2Bottleneck(cin, width, (1 if stage == 0 else 2) if b == 0 else 1))
                cin = width * 4
            setattr(self, f"res{stage + 2}", nn.Sequential(*blocks))

    def forward(self, x: Tensor) -> list[Tensor]:
        x = self.stem(x)
        feats = []
        for s in range(2, 6):
            x = getattr(self, f"res{s}")(x)
            feats.append(x)
        return feats


class FPN(nn.Module):
    """detectron2's ``backbone``: the trunk as ``bottom_up``, lateral 1×1 +
    top-down nearest ×2 (cropped to the lateral) + output 3×3 → P2..P5, and
    P6 = P5 subsampled by 2 (a 1×1 max-pool of stride 2)."""

    def __init__(self):
        super().__init__()
        self.bottom_up = D2ResNet50()
        for i, cin in enumerate((256, 512, 1024, 2048)):
            setattr(self, f"fpn_lateral{i + 2}", nn.Conv2d(cin, 256, 1))
            setattr(self, f"fpn_output{i + 2}", nn.Conv2d(256, 256, 3, padding=1))

    def forward(self, x: Tensor) -> list[Tensor]:
        c = self.bottom_up(x)
        lat = [getattr(self, f"fpn_lateral{i + 2}")(ci) for i, ci in enumerate(c)]
        p = [None] * 4
        p[3] = lat[3]
        for i in (2, 1, 0):
            up = F.interpolate(p[i + 1], scale_factor=2, mode="nearest")
            p[i] = lat[i] + up[:, :, : lat[i].shape[2], : lat[i].shape[3]]
        outs = [getattr(self, f"fpn_output{i + 2}")(pi) for i, pi in enumerate(p)]
        return outs + [outs[3][:, :, ::2, ::2]]


class RPNHead(nn.Module):
    """Shared 3×3 conv, then objectness (A) and anchor deltas (4A) per level."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(256, 256, 3, padding=1)
        self.objectness_logits = nn.Conv2d(256, len(ANCHOR_RATIOS), 1)
        self.anchor_deltas = nn.Conv2d(256, 4 * len(ANCHOR_RATIOS), 1)

    def forward(self, feats: list[Tensor]) -> tuple[list[Tensor], list[Tensor]]:
        logits, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t).float())
            deltas.append(self.anchor_deltas(t).float())
        return logits, deltas


class _ProposalGenerator(nn.Module):
    def __init__(self):
        super().__init__()
        self.rpn_head = RPNHead()


class BoxHead(nn.Module):
    """2×FC1024 on (R, 256·7·7) ROI features flattened in NCHW order, as
    detectron2 flattens them."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(256 * 7 * 7, 1024)
        self.fc2 = nn.Linear(1024, 1024)

    def forward(self, x: Tensor) -> Tensor:
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class BoxPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.cls_score = nn.Linear(1024, NUM_CLASSES + 1)
        self.bbox_pred = nn.Linear(1024, NUM_CLASSES * 4)


class MaskHead(nn.Module):
    """4 convs, a 2×2 stride-2 deconv and the per-class predictor:
    (R, 256, 14, 14) → (R, NUM_CLASSES, 28, 28) logits."""

    def __init__(self):
        super().__init__()
        for i in range(4):
            setattr(self, f"mask_fcn{i + 1}", nn.Conv2d(256, 256, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(256, 256, 2, 2)
        self.predictor = nn.Conv2d(256, NUM_CLASSES, 1)

    def forward(self, x: Tensor) -> Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class _ROIHeads(nn.Module):
    def __init__(self):
        super().__init__()
        self.box_head = BoxHead()
        self.box_predictor = BoxPredictor()
        self.mask_head = MaskHead()


# ------------------------------------------------------------ box utilities


def anchors_for_level(h: int, w: int, stride: int, size: float) -> np.ndarray:
    """(H·W·A, 4) XYXY anchors, detectron2's grid convention (centres at
    stride·(i, j), no +0.5 offset)."""
    out = []
    for ratio in ANCHOR_RATIOS:
        aw = np.sqrt(size * size / ratio)
        ah = aw * ratio
        out.append((-aw / 2, -ah / 2, aw / 2, ah / 2))
    base = np.array(out, np.float32)
    xs = np.arange(w, dtype=np.float32) * stride
    ys = np.arange(h, dtype=np.float32) * stride
    sx, sy = np.meshgrid(xs, ys, indexing="xy")
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(anchors: Tensor, deltas: Tensor, weights=(1.0, 1.0, 1.0, 1.0)) -> Tensor:
    """detectron2's Box2BoxTransform.apply_deltas (dx, dy, dw, dh) on (..., 4),
    with dw and dh clamped at log(1000/16) = 4.135."""
    wx, wy, ww, wh = weights
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + 0.5 * aw
    ay = anchors[..., 1] + 0.5 * ah
    dx = deltas[..., 0] / divisor(deltas, wx)
    dy = deltas[..., 1] / divisor(deltas, wy)
    dw = torch.clamp(deltas[..., 2] / divisor(deltas, ww), max=4.135)
    dh = torch.clamp(deltas[..., 3] / divisor(deltas, wh), max=4.135)
    cx = dx * aw + ax
    cy = dy * ah + ay
    w = torch.exp(dw) * aw
    h = torch.exp(dh) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def _bound(v, boxes: Tensor) -> Tensor:
    """A height or width (a number, or one per image) broadcastable against
    ``boxes[..., 0]`` whose leading axis is the image."""
    t = torch.as_tensor(v, dtype=torch.float32, device=boxes.device)
    return t.reshape(t.shape + (1,) * (boxes.ndim - 1 - t.ndim)) if t.ndim else t


def clip_boxes(boxes: Tensor, height, width) -> Tensor:
    """Clip (..., 4) XYXY boxes to [0, width] × [0, height] (``jnp.clip``:
    max with 0, then min with the bound)."""
    h, w = _bound(height, boxes), _bound(width, boxes)
    x1 = torch.minimum(boxes[..., 0].clamp(min=0), w)
    y1 = torch.minimum(boxes[..., 1].clamp(min=0), h)
    x2 = torch.minimum(boxes[..., 2].clamp(min=0), w)
    y2 = torch.minimum(boxes[..., 3].clamp(min=0), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def iou_matrix(a: Tensor, b: Tensor) -> Tensor:
    """(n, m) IoU of XYXY boxes, with max(·, 0) areas and +1e-12."""
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-12)


def _top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest along the last axis, ties to the lower index
    (``jax.lax.top_k``'s order): a stable descending sort."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """x (N, n, ...) indexed per image by idx (N, m) → (N, m, ...)."""
    idx = idx.long()
    return x.gather(1, idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(idx.shape + x.shape[2:]))


def paste_masks(masks28: Tensor, boxes: Tensor, out_h: int, out_w: int) -> Tensor:
    """Paste (..., 28, 28) mask probabilities into (..., out_h, out_w)
    canvases by inverse bilinear sampling, as separable weights: two float32
    ``bmm``s, (R, H, 28)·(R, 28, 28)·(R, 28, W). The weight of source cell a
    for target pixel t is max(0, 1 − |m(t) − a|), zero outside the box."""
    lead = masks28.shape[:-2]
    m = masks28.reshape(-1, MASK_RES, MASK_RES).float()
    b = boxes.reshape(-1, 4).float()
    x1, y1, x2, y2 = b.unbind(-1)
    bw = torch.clamp(x2 - x1, min=1e-6)
    bh = torch.clamp(y2 - y1, min=1e-6)
    a = torch.arange(MASK_RES, dtype=torch.float32, device=m.device)

    def weights(size: int, lo: Tensor, span: Tensor) -> Tensor:  # (R, T, 28)
        t = torch.arange(size, dtype=torch.float32, device=m.device) + 0.5
        mm = (t[None, :] - lo[:, None]) / span[:, None] * MASK_RES - 0.5
        return torch.clamp(1.0 - (mm[:, :, None] - a[None, None, :]).abs(), 0.0, 1.0)

    with torch.autocast(m.device.type, enabled=False):
        tmp = torch.bmm(weights(out_h, y1, bh), m)                      # (R, H, 28)
        out = torch.bmm(tmp, weights(out_w, x1, bw).transpose(1, 2))    # (R, H, W)
    return out.reshape(lead + (out_h, out_w))


# -------------------------------------------------------------- full model


class Detections(NamedTuple):
    boxes: Tensor    # (N, max_det, 4) XYXY in input-image coordinates
    scores: Tensor   # (N, max_det)
    classes: Tensor  # (N, max_det) int32 category ids (0..NUM_CLASSES-1)
    masks28: Tensor  # (N, max_det, 28, 28) probabilities
    valid: Tensor    # (N, max_det) bool


class MaskRCNN(nn.Module):
    """The whole static-shape inference graph over a batch of images.

    ``forward(images, true_h, true_w)``: images (N, H, W, 3) caffe-BGR
    normalized, padded to one static size; the true height and width, one
    number for the batch or one per image. The top-k and NMS sizes are
    attributes so tests can shrink them; the defaults are detectron2's
    test-time config. ``dtype`` is the networks' compute type (bf16 through
    autocast), ``roi_dtype`` the ROIAlign features' type (the training-time
    provider pools in bf16, the GT-tooling backend in f32)."""

    def __init__(self, max_det: int = 32, pre_nms_topk: int = RPN_PRE_NMS_TOPK,
                 post_nms_topk: int = RPN_POST_NMS_TOPK, box_candidates: int = 1024,
                 score_thresh: float = ROI_SCORE_THRESH, dtype: torch.dtype = torch.bfloat16,
                 roi_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_det, self.pre_nms_topk, self.post_nms_topk = max_det, pre_nms_topk, post_nms_topk
        self.box_candidates, self.score_thresh = box_candidates, score_thresh
        self.dtype, self.roi_dtype = dtype, roi_dtype
        self.backbone = FPN()
        self.proposal_generator = _ProposalGenerator()
        self.roi_heads = _ROIHeads()
        self._anchors: dict[tuple, Tensor] = {}

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights (``d2_allow_random_weights``) by detectron2's own
        initializers: MSRA fan-out for the trunk and mask-head convs, "c2
        xavier" (uniform, fan-in) for the FPN and box-head fc layers, normal
        std 0.01 for the RPN head and the class scores, 0.001 for the box
        deltas and the mask predictor; zero biases. The frozen BN statistics
        are then set from one forward of a random blocky image from ``generator``
        (each BN normalizes what reaches it), so the random trunk's
        activations stay at unit scale, as a trained one's do: its proposals
        and class scores are then neither degenerate nor saturated."""
        def normal(m, std):
            with torch.no_grad():
                m.weight.normal_(0.0, std, generator=generator)

        for name, m in self.named_modules():
            if isinstance(m, BatchNorm2d):
                with torch.no_grad():
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                continue
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                continue
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("proposal_generator") or leaf == "cls_score":
                normal(m, 0.01)
            elif leaf in ("bbox_pred", "predictor"):
                normal(m, 0.001)
            elif name.startswith(("backbone.fpn", "roi_heads.box_head")):
                nn.init.kaiming_uniform_(m.weight, a=1, generator=generator)
            else:
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        self._calibrate_frozen_bn(generator)

    @torch.no_grad()
    def _calibrate_frozen_bn(self, generator: torch.Generator) -> None:
        def set_stats(bn, inputs):
            x = inputs[0].float()
            bn.running_mean.copy_(x.mean((0, 2, 3)))
            bn.running_var.copy_(x.var((0, 2, 3), unbiased=False).clamp(min=1e-3))

        was_training = self.training
        self.eval()
        hooks = [m.register_forward_pre_hook(set_stats) for m in self.modules() if isinstance(m, BatchNorm2d)]
        try:
            # a caffe-normalized image of random 8×8 blocks
            blocks = 255.0 * torch.rand(1, 3, 16, 16, generator=generator) - 128.0
            self.backbone.bottom_up(blocks.repeat_interleave(8, 2).repeat_interleave(8, 3))
        finally:
            for h in hooks:
                h.remove()
            self.train(was_training)

    def _anchor_grid(self, li: int, h: int, w: int, device: torch.device) -> Tensor:
        key = (li, h, w, str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(
                anchors_for_level(h, w, 2 ** (li + 2), ANCHOR_SIZES[li])).to(device)
        return self._anchors[key]

    def _proposals(self, logits, deltas, true_h, true_w) -> tuple[Tensor, Tensor]:
        """Per-level top-k, decode, clip, then one NMS keyed by level (each
        level offset into its own coordinate range): (N, post_nms_topk, 4)
        proposals, invalid ones degenerate at 0, and their validity."""
        n = logits[0].shape[0]
        dev = logits[0].device
        all_boxes, all_scores, all_lvls = [], [], []
        for li, (lg, dl) in enumerate(zip(logits, deltas)):
            hl, wl = lg.shape[2], lg.shape[3]
            scores_l = lg.permute(0, 2, 3, 1).reshape(n, -1)
            deltas_l = dl.permute(0, 2, 3, 1).reshape(n, -1, 4)
            k = min(self.pre_nms_topk, scores_l.shape[1])
            top_s, top_i = _top_k(scores_l, k)
            anch = self._anchor_grid(li, hl, wl, dev)[top_i]
            all_boxes.append(clip_boxes(decode_boxes(anch, _take(deltas_l, top_i)), true_h, true_w))
            all_scores.append(top_s)
            all_lvls.append(torch.full((k,), float(li), device=dev))
        boxes = torch.cat(all_boxes, 1)
        lvl_off = torch.cat(all_lvls)[:, None] * (MAX_SIZE_TEST * 2.0)
        keep, valid = nms(boxes + lvl_off, torch.cat(all_scores, 1), RPN_NMS_THRESH, self.post_nms_topk)
        return _take(boxes, keep) * valid[..., None], valid

    def forward(self, images: Tensor, true_h, true_w) -> Detections:
        n = images.shape[0]
        dev = images.device
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16):
            x = images.permute(0, 3, 1, 2)
            if dev.type == "cuda":
                x = x.contiguous(memory_format=torch.channels_last)
            pyramid = self.backbone(x.to(self.dtype))
            logits, deltas = self.proposal_generator.rpn_head(pyramid)
            proposals, valid = self._proposals(logits, deltas, true_h, true_w)

            # ---- box head: NHWC levels for ROIAlign, NCHW flatten for fc1
            roi_feats = [p.permute(0, 2, 3, 1).to(self.roi_dtype) for p in pyramid[:4]]
            pooled = multilevel_roi_align(roi_feats, proposals, 7)       # (N, R, 7, 7, C)
            r = proposals.shape[1]
            heads = self.roi_heads
            h = heads.box_head(pooled.permute(0, 1, 4, 2, 3).reshape(n * r, -1).to(self.dtype))
            cls_logits = heads.box_predictor.cls_score(h).float().reshape(n, r, -1)
            box_deltas = heads.box_predictor.bbox_pred(h).float().reshape(n, r, NUM_CLASSES, 4)
            probs = torch.softmax(cls_logits, dim=-1)[..., :NUM_CLASSES]  # drop background

            # class-specific regression; threshold to 0, top candidates,
            # then NMS keyed by class
            det_boxes = decode_boxes(proposals[:, :, None, :].expand(n, r, NUM_CLASSES, 4), box_deltas,
                                     BOX_REG_WEIGHTS)
            flat_scores = (probs * valid[..., None]).reshape(n, -1)
            flat_boxes = det_boxes.reshape(n, -1, 4)
            flat_cls = torch.arange(NUM_CLASSES, dtype=torch.int32, device=dev).repeat(r)
            flat_scores = torch.where(flat_scores >= self.score_thresh, flat_scores, 0.0)
            cs, ci = _top_k(flat_scores, min(self.box_candidates, flat_scores.shape[1]))
            cboxes = clip_boxes(_take(flat_boxes, ci), true_h, true_w)
            ccls = flat_cls[ci]
            off = ccls.float()[..., None] * (MAX_SIZE_TEST * 2.0)
            keep2, valid2 = nms(cboxes + off, cs, ROI_NMS_THRESH, self.max_det)
            kept_scores = _take(cs, keep2)
            valid2 = valid2 & (kept_scores > 0)
            final_boxes = _take(cboxes, keep2)
            final_scores = kept_scores * valid2
            final_cls = _take(ccls, keep2)

            # ---- mask head on the detections
            mpooled = multilevel_roi_align(roi_feats, final_boxes, 14)   # (N, D, 14, 14, C)
            d = self.max_det
            m = mpooled.reshape(n * d, 14, 14, -1).permute(0, 3, 1, 2).to(self.dtype)
            mlogits = heads.mask_head(m).float()                        # (N·D, classes, 28, 28)
        sel = mlogits[torch.arange(n * d, device=dev), final_cls.reshape(-1).long()]
        masks28 = torch.sigmoid(sel).reshape(n, d, MASK_RES, MASK_RES)
        return Detections(final_boxes, final_scores, final_cls, masks28, valid2)


def paste_threshold_union_ready(det: Detections, boxes: Tensor, out_h: int, out_w: int) -> Tensor:
    """Paste detections to (..., max_det, out_h, out_w) and binarize at 0.5,
    invalid slots zeroed — the shared tail of both inference pipelines."""
    return (paste_masks(det.masks28, boxes, out_h, out_w) >= 0.5) & det.valid[..., None, None]


def build_model_and_weights(max_det: int, weights_path: str | dict | None = None, fast: bool = False,
                            score_thresh: float = ROI_SCORE_THRESH, roi_dtype: torch.dtype = torch.float32,
                            dtype: torch.dtype = torch.bfloat16,
                            device: str | torch.device | None = None) -> MaskRCNN:
    """The shared construction for every Mask R-CNN consumer (backend,
    provider): the proposal budget, the weights from ``weights_path`` (a
    ``.pth`` or a detectron2-keyed state dict) by a strict import or random
    from seed 0, frozen (eval mode, no gradients), on ``device`` (``cuda``
    unless asked otherwise; channels-last there)."""
    device = resolve_device(device)
    model = MaskRCNN(max_det=max_det, score_thresh=score_thresh, dtype=dtype, roi_dtype=roi_dtype,
                     **(FAST_BUDGET if fast else {}))
    if isinstance(weights_path, dict):
        import_detectron2_state_dict(weights_path, model)
    elif weights_path:
        import_detectron2_pth(weights_path, model)
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    if device.type == "cuda":
        use_full_f32()
        model.to(device=device, memory_format=torch.channels_last)
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------- host interface


def preprocess_np(img_rgb: np.ndarray, input_hw: tuple[int, int] | None = None
                  ) -> tuple[np.ndarray, float, int, int]:
    """ResizeShortestEdge(1024, 2048) + BGR caffe normalization + pad to the
    static input shape. Returns (padded (Hs, Ws, 3) float32, scale,
    resized_h, resized_w)."""
    import cv2

    h, w = img_rgb.shape[:2]
    sh, sw = input_hw if input_hw is not None else static_input_shape()
    scale = min(MIN_SIZE_TEST / min(h, w), MAX_SIZE_TEST / max(h, w), sh / h, sw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = cv2.resize(img_rgb.astype(np.float32), (nw, nh))
    bgr = resized[:, :, ::-1] - np.array(PIXEL_MEAN_BGR, np.float32)
    out = np.zeros((sh, sw, 3), np.float32)
    out[:nh, :nw] = bgr[:sh, :sw]
    return out, scale, nh, nw


def static_input_shape() -> tuple[int, int]:
    """The static padded input for KITTI frames: ResizeShortestEdge(1024,
    2048) maps 375×1242 → 619×2048, rounded up to /64 for the FPN strides."""
    return 640, 2048


def _mean_bgr(device: torch.device) -> Tensor:
    return torch.tensor(PIXEL_MEAN_BGR, dtype=torch.float32, device=device)


class MaskRCNNBackend:
    """Host-facing inference for GT tooling: detectron2's 1024-edge pipeline
    at a static padded input, f32 ROIAlign, the whole batch in one forward.
    Only fixed-size uint8 masks and the detection table come back to the
    host. (The JAX backend's spatial mesh has no counterpart here.)"""

    def __init__(self, weights_path: str | None = None, max_det: int = 32, fast: bool = False,
                 score_thresh: float = ROI_SCORE_THRESH, input_hw: tuple[int, int] | None = None,
                 device: str | torch.device | None = None):
        sh, sw = input_hw if input_hw is not None else static_input_shape()
        if sh % 64 or sw % 64:
            raise ValueError(f"input shape must be /64 for the FPN, got {(sh, sw)}")
        self.input_hw = (sh, sw)
        self.device = resolve_device(device)
        self.model = build_model_and_weights(max_det, weights_path, fast, score_thresh, device=self.device)

    @torch.no_grad()
    def _run(self, padded: Tensor, nh: Tensor, nw: Tensor, scale: Tensor, out_h: int, out_w: int):
        det = self.model(padded, nh, nw)
        boxes = det.boxes / scale[:, None, None]
        masks = paste_threshold_union_ready(det, boxes, out_h, out_w)
        return masks, boxes, det

    def predict_batch(self, imgs_rgb) -> list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Same-(H, W) uint8 RGB images → per image (masks (n, H, W) uint8,
        boxes (n, 4), classes (n,), scores (n,)) of its valid detections, at
        the original resolution."""
        h, w = np.asarray(imgs_rgb[0]).shape[:2]
        pp = []
        for im in imgs_rgb:
            im = np.asarray(im)
            if im.shape[:2] != (h, w):
                raise ValueError("predict_batch needs same-size images")
            pp.append(preprocess_np(im, self.input_hw))
        dev = self.device

        def col(i):
            return torch.tensor([p[i] for p in pp], dtype=torch.float32, device=dev)

        padded = torch.from_numpy(np.stack([p[0] for p in pp])).to(dev)
        masks, boxes, det = self._run(padded, col(2), col(3), col(1), h, w)
        masks, boxes = masks.to(torch.uint8).cpu().numpy(), boxes.cpu().numpy()
        classes, scores, valid = det.classes.cpu().numpy(), det.scores.cpu().numpy(), det.valid.cpu().numpy()
        return [(masks[i][valid[i]], boxes[i][valid[i]], classes[i][valid[i]], scores[i][valid[i]])
                for i in range(len(pp))]

    def predict(self, img_rgb: np.ndarray):
        """(H, W, 3) uint8 RGB → (masks (n, H, W) uint8, boxes (n, 4),
        classes (n,), scores (n,)) at the original resolution."""
        return self.predict_batch([img_rgb])[0]

    def predict_union_batch(self, imgs_rgb) -> np.ndarray:
        """Same-(H, W) uint8 RGB images → (B, H, W) uint8 0/1 union masks: the
        uint8 frames resized to the shortest-edge scale on the host (cv2, as
        detectron2 resizes the uint8 image), then BGR, normalization, padding,
        detection, paste and union on the device."""
        import cv2

        h, w = np.asarray(imgs_rgb[0]).shape[:2]
        sh, sw = self.input_hw
        scale = min(MIN_SIZE_TEST / min(h, w), MAX_SIZE_TEST / max(h, w), sh / h, sw / w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        resized = []
        for im in imgs_rgb:
            im = np.asarray(im)
            if im.shape[:2] != (h, w):
                raise ValueError("predict_union_batch needs same-size images")
            resized.append(cv2.resize(im, (nw, nh)))
        dev = self.device
        u8 = torch.from_numpy(np.stack(resized)).to(dev)
        b = u8.shape[0]
        padded = torch.zeros(b, sh, sw, 3, dtype=torch.float32, device=dev)
        padded[:, :nh, :nw] = u8.flip(-1).float() - _mean_bgr(dev)
        full = torch.full((b,), 1.0, device=dev)
        masks, _, _ = self._run(padded, full * nh, full * nw, full * scale, h, w)
        return masks.any(1).to(torch.uint8).cpu().numpy()

    def predict_union(self, img_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 → (H, W) uint8 0/1 union mask."""
        return self.predict_union_batch([img_rgb])[0]


class MaskRCNNProvider:
    """The live union-mask provider for DS/DC training (the reference runs
    frozen detectron2 on every batch): the whole batch in one forward at
    ``d2_infer_scale ×`` the training resolution (384×1280 for 192×640),
    the fast proposal budget, bf16 ROIAlign. :meth:`union_fn` is what the
    fused train step calls on the augmented frame; the Trainer calls
    :meth:`union_masks_from_images` on the raw host frame when
    ``d2_fuse_step`` is off. ``weights``: a detectron2-keyed state dict to
    use instead of ``{log_dir}/model_final_detectron2.pth`` (the synthetic
    rehearsal's crafted detector)."""

    def __init__(self, cfg, device: str | torch.device | None = None, weights: dict | None = None):
        scale = int(cfg.d2_infer_scale)
        ih, iw = cfg.height * scale, cfg.width * scale
        if ih % 64 or iw % 64:
            raise ValueError(f"the d2 inference shape {(ih, iw)} must be /64 for the FPN")
        if weights is None:
            weights = os.path.join(cfg.log_dir, "model_final_detectron2.pth")
        if isinstance(weights, str) and not os.path.exists(weights):
            # a DS/DC run supervised by a randomly initialized Mask R-CNN
            # trains against garbage with no other symptom: fail fast unless
            # the caller opts in
            if not cfg.d2_allow_random_weights:
                raise FileNotFoundError(
                    f"mask_provider=maskrcnn needs detectron2 weights at {weights} — place "
                    "model_final_detectron2.pth in log_dir, or set d2_allow_random_weights=true to "
                    "accept randomly initialized masks (tests/smoke only)")
            print(f"WARNING: {weights} not found — Mask R-CNN provider running with RANDOM weights "
                  "(d2_allow_random_weights); DS/DC supervision is garbage. Do not train real runs "
                  "like this.", flush=True)
            weights = None
        self.device = resolve_device(device)
        self.scale = scale
        self.infer_hw = (ih, iw)
        self.out_hw = (cfg.height, cfg.width)
        self.model = build_model_and_weights(cfg.d2_max_instances, weights, fast=True,
                                             score_thresh=cfg.d2_score_thresh, roi_dtype=torch.bfloat16,
                                             device=self.device)

    @torch.no_grad()
    def union_fn(self, images: Tensor) -> Tensor:
        """(B, H0, W0, 3) RGB in [0, 255] (uint8 or float) → (B, height,
        width) float32 union masks: the non-antialiased bilinear resize to the
        inference shape, RGB → BGR, caffe mean, the batched Mask R-CNN, boxes
        back to training coordinates, paste, threshold at 0.5, max over
        instances."""
        from ..geometry import resize_bilinear

        ih, iw = self.infer_hw
        x = resize_bilinear(images.float(), ih, iw)
        x = x.flip(-1) - _mean_bgr(x.device)
        det = self.model(x, float(ih), float(iw))
        keep = paste_threshold_union_ready(det, det.boxes / float(self.scale), *self.out_hw)
        return keep.any(1).float()

    def union_masks_from_images(self, images_rgb, height: int, width: int) -> Tensor:
        """(B, H0, W0, 3) uint8 RGB (numpy or a tensor) → (B, height, width)
        float32 union masks on the provider's device."""
        if (height, width) != self.out_hw:
            raise ValueError(f"this provider makes {self.out_hw} masks, not {(height, width)}")
        return self.union_fn(torch.as_tensor(np.asarray(images_rgb) if not torch.is_tensor(images_rgb)
                                             else images_rgb).to(self.device))

    def union_masks(self, keys, height, width):  # MaskProvider protocol
        raise RuntimeError(
            "MaskRCNNProvider needs images, not sample keys — the trainer must call "
            "union_masks_from_images. (A keyed lookup would silently train DS/DC against all-zero masks.)")


# ------------------------------------------------------------- .pth import

# keys of a detectron2 R50-FPN checkpoint with no counterpart here (constants
# rebuilt in anchors_for_level / training-only state)
_IGNORABLE_D2_PREFIXES = (
    "proposal_generator.anchor_generator.",
    "pixel_mean",
    "pixel_std",
)


def import_detectron2_state_dict(sd: dict, model: MaskRCNN, strict: bool = True) -> MaskRCNN:
    """Load a detectron2 state dict into ``model`` (its keys are
    detectron2's, so no layout changes). With ``strict``, every key must be
    the model's or a known-ignorable one, and every parameter and buffer of
    the model must be filled, with its shape."""
    own = model.state_dict()
    loaded, unmapped = {}, []
    for key, val in sd.items():
        if key.startswith(_IGNORABLE_D2_PREFIXES):
            continue
        if key not in own:
            unmapped.append(key)
            continue
        loaded[key] = torch.as_tensor(val.detach().cpu() if hasattr(val, "detach") else np.asarray(val))
    if strict:
        if unmapped:
            raise ValueError(f"unmapped detectron2 keys ({len(unmapped)}): {unmapped[:8]} ...")
        if len(loaded) != len(own):
            missing = [k for k in own if k not in loaded]
            raise ValueError(f"checkpoint fills {len(loaded)} leaves but the model has {len(own)}; "
                             f"unfilled: {missing[:8]} ...")
        for k, v in loaded.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch at {k}: got {tuple(v.shape)}, model wants {tuple(own[k].shape)}")
    model.load_state_dict(loaded, strict=strict)
    return model


def import_detectron2_pth(path: str, model: MaskRCNN, strict: bool = True) -> MaskRCNN:
    """Load the reference's ``model_final_detectron2.pth`` into ``model``."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return import_detectron2_state_dict(sd, model, strict=strict)
