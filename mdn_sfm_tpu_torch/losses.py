"""Loss core: epipolar supervision with mode-dispatched post-processing — the
port of ``mdn_sfm_tpu.losses``. NHWC tensors throughout.

Reference quirks reproduced on purpose, as in the JAX package:

* SN mode's "original" map is the max-normalized (pre-square) map — the
  reference normalizes in place before logging it.
* With min-fusion, the smooth loss is accumulated once per reference frame
  with the SAME min-fused mask, i.e. counted twice per scale.
* Per-scale terms are divided by 2**scale.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.nn.functional as F

from .config import Config, Mode
from .geometry import (
    gauss_distance_weight,
    inverse_warp,
    resize_bilinear,
    scale_factor,
)
from .ops.epipolar import EpipolarMap, epipolar_abs_residual_maps, epipolar_abs_residual_maps_reference
from .utils import divisor

Tensor = torch.Tensor


# -------------------------------------------------------------- primitives


def smooth_loss(target: Tensor, mobile: Tensor) -> Tensor:
    """Edge-aware smoothness of the mobile map (B, H, W, 1) w.r.t. the image
    gradients of ``target`` (B, H, W, C)."""
    target = target.float()
    mobile = mobile.float()
    grad_img_x = (target[:, :, :-1] - target[:, :, 1:]).abs().mean(-1, keepdim=True)
    grad_img_y = (target[:, :-1] - target[:, 1:]).abs().mean(-1, keepdim=True)
    grad_mob_x = (mobile[:, :, :-1] - mobile[:, :, 1:]).abs()
    grad_mob_y = (mobile[:, :-1] - mobile[:, 1:]).abs()
    return (grad_mob_x * torch.exp(-grad_img_x)).mean() + (grad_mob_y * torch.exp(-grad_img_y)).mean()


def derivable_consistency_loss(m1: Tensor, m2: Tensor, threshold: float = 0.5) -> Tensor:
    """Soft-binarized forward/backward mask consistency (per-pixel map)."""
    a1 = torch.sigmoid(20.0 * (m1.float() - threshold))
    a2 = torch.sigmoid(20.0 * (m2.float() - threshold))
    return (a1 - a2) ** 2


def instance_similarity_bce(mobile: Tensor, instance_mask: Tensor) -> Tensor:
    """Per-pixel BCE between the mobile map (B, H, W, 1) and the instance-union
    mask (B, Hm, Wm[, 1]), resized bilinearly to the map's resolution."""
    mobile = mobile.float()
    if instance_mask.ndim == 3:
        instance_mask = instance_mask[..., None]
    m = resize_bilinear(instance_mask.float(), mobile.shape[1], mobile.shape[2])
    return -(m * torch.log(mobile + 1e-10) + (1.0 - m) * torch.log(1.0 - mobile + 1e-10))


def ssim(x: Tensor, y: Tensor) -> Tensor:
    """SSIM distance map (1-SSIM)/2 in [0, 1], 3×3 average pooling over
    reflect-padded NHWC inputs."""
    x = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y = F.pad(y.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")

    def pool(t: Tensor) -> Tensor:
        return F.avg_pool2d(t, 3, 1)

    mu_x, mu_y = pool(x), pool(y)
    sig_x = pool(x * x) - mu_x**2
    sig_y = pool(y * y) - mu_y**2
    sig_xy = pool(x * y) - mu_x * mu_y
    c1, c2 = 0.01**2, 0.03**2
    n = (2 * mu_x * mu_y + c1) * (2 * sig_xy + c2)
    d = (mu_x**2 + mu_y**2 + c1) * (sig_x + sig_y + c2)
    return torch.clamp((1.0 - n / d) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)


def photometric_loss(
    target: Tensor, reference: Tensor, flow: Tensor, use_ssim: bool, padding_mode: str = "zeros"
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """L1 (+0.85·SSIM) photometric loss over the inverse-warped reference."""
    warped, valid = inverse_warp(reference, flow, padding_mode)
    diff = (target.float() - warped.float()).abs() * valid
    loss = diff.mean()
    if use_ssim:
        loss = 0.15 * loss + 0.85 * ssim(target, warped).mean()
    return loss, warped, diff, valid


def divergence(foreground: Tensor, feature: Tensor) -> Tensor:
    """KL-style divergence between the dynamic-region feature distribution
    and its spatial mean. foreground (B, H, W, 1), feature (B, H, W, C)."""
    foreground = foreground.float()
    feature = feature.float()
    dynamic = foreground * feature
    center = dynamic.mean((1, 2), keepdim=True)
    dy = torch.softmax(dynamic, -1)
    cd = torch.softmax(center, -1).expand_as(dy)
    div = (dy * torch.log(dy / cd + 1e-5)).abs()
    return div.sum() / foreground.sum()


# -------------------------------------------------- mode post-processing


def post_process_epipolar(
    mode: Mode,
    epipolar_map: Tensor,
    *,
    threshold: float | None = None,
    gauss_weight: Tensor | None = None,
    instance_mask: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Per-mode post-processing of the (B, H, W, 1) |epipolar residual| map.

    Returns (post, ori): the post-processed map and the map to log as
    "original" (the max-normalized map in SN/DC mode, see module doc)."""
    epipolar_map = epipolar_map.float()
    if mode in (Mode.SN, Mode.DC):
        b = epipolar_map.shape[0]
        norms = epipolar_map.reshape(b, -1).amax(1).reshape(b, 1, 1, 1)
        normalized = epipolar_map / norms
        return normalized**2, normalized
    if mode == Mode.T:
        return (epipolar_map / divisor(epipolar_map, threshold)) ** 2, epipolar_map
    if mode == Mode.TG:
        post = epipolar_map
        if threshold is not None:
            post = post / divisor(post, threshold)
        post = post / gauss_weight[None, :, :, None]
        return post**2, epipolar_map
    if mode == Mode.DS:
        if instance_mask is None:
            raise ValueError(
                "mode=DS requires instance masks — configure mask_provider "
                "(precomputed/maskrcnn)"
            )
        if instance_mask.ndim == 3:
            instance_mask = instance_mask[..., None]
        m = resize_bilinear(instance_mask.float(), epipolar_map.shape[1], epipolar_map.shape[2])
        return m * epipolar_map, epipolar_map
    raise ValueError(f"unknown mode {mode}")


# --------------------------------------------------------- the full loss


class LossAux(NamedTuple):
    """Per-step side outputs for logging."""

    epipolars: dict      # {(frame, 0): (B, H, W, 1) post-processed map}
    epipolar_ori: dict   # {(frame, 0): (B, H, W, 1) "original" map}
    flows: dict          # {(frame, 0): (B, H, W, 2) pixel flow}
    min_mobiles: dict    # {scale: (B, Hs, Ws, 1)}


def epipolar_loss_terms(
    cfg: Config,
    resid: Tensor,
    mobile: Tensor,
    instance_mask: Tensor | None,
    gauss_weight: Tensor | None,
) -> tuple[Tensor, Tensor, Tensor]:
    """One (frame, scale) epipolar loss from its |epipolar residual| map
    ``resid`` (B, H, W):

    mean(background·post) + α·mean(|mobile·log(background+1e-5)|)
    [+ w_d2_sim·mean(BCE(mobile, instance_union))]

    Returns (scalar loss, post map, ori map).
    """
    post, ori = post_process_epipolar(
        cfg.mode,
        resid[..., None],
        threshold=cfg.threshold,
        gauss_weight=gauss_weight,
        instance_mask=instance_mask,
    )

    mobile = mobile.float()
    background = 1.0 - mobile
    epip = (background * post).mean()
    non_trivial = (mobile * torch.log(background + 1e-5)).abs().mean()
    loss = epip + cfg.alpha * non_trivial

    # BCE similarity term: DC always (with a mask, else fail fast); SN with
    # w_d2_sim > 0 and a mask (the reference's combined SN+DC head); DS only
    # behind ds_similarity_term; never T/TG.
    if cfg.mode == Mode.DC:
        if instance_mask is None:
            raise ValueError(
                "mode=DC requires instance masks — configure mask_provider "
                "(precomputed/maskrcnn); refusing to train the BCE term "
                "against an implicit all-zero mask"
            )
        loss = loss + cfg.w_d2_sim * instance_similarity_bce(mobile, instance_mask).mean()
    elif cfg.mode == Mode.SN and cfg.w_d2_sim > 0 and instance_mask is not None:
        loss = loss + cfg.w_d2_sim * instance_similarity_bce(mobile, instance_mask).mean()
    elif cfg.mode == Mode.DS and cfg.ds_similarity_term and cfg.w_d2_sim > 0:
        loss = loss + cfg.w_d2_sim * instance_similarity_bce(mobile, instance_mask).mean()

    return loss, post, ori


def compute_losses(
    cfg: Config,
    colors: Mapping[tuple[int, int], Tensor],
    inv_Ks: Mapping[int, Tensor],
    flows: Mapping[tuple[int, int], Tensor],
    mobiles: Mapping[tuple[int, int], Tensor],
    cam_T_cams: Mapping[int, Tensor],
    instance_mask: Tensor | None = None,
) -> tuple[dict[str, Tensor], LossAux]:
    """Full multi-scale multi-frame loss.

    The step's |epipolar residual| maps come from one call. While flow and
    pose are frozen they carry no gradient, and the call is
    :func:`~.ops.epipolar.epipolar_abs_residual_maps`: the CUDA kernel on
    the card, its plain version on the CPU. With ``fine_tune_flow_motion``,
    or ``use_pallas_epipolar=False``, the config takes the plain version
    with autograd on every device, as the JAX package takes plain XLA there.

    Args:
        colors: {(frame_id, scale): (B, Hs, Ws, 3) normalized image}.
        inv_Ks: {scale: (B, 3+, 3+) inverse intrinsics}.
        flows: {(frame_id, scale): (B, Hs, Ws, 2) NORMALIZED flow}; multiplied
            by [Ws, Hs] here (inside the epipolar kernel on the card).
        mobiles: {(frame_id, scale): (B, Hs, Ws, 1) sigmoid mobile maps}.
        cam_T_cams: {frame_id: (B, 4, 4)}.
        instance_mask: (B, Hm, Wm) instance-union mask in [0, 1], or None.
    Returns:
        (losses dict with keys loss/epip/smooth/consis[/photo], LossAux).
    """
    frame_ids = cfg.ref_frame_ids
    device = colors[(0, cfg.scales[0])].device
    gauss = (
        gauss_distance_weight(
            cfg.height, cfg.width, max(cfg.scales) + 1, cfg.gauss_sigma1, cfg.gauss_sigma2,
            device=device,
        )
        if cfg.mode == Mode.TG
        else None
    )

    zero = torch.zeros((), dtype=torch.float32, device=device)
    losses = {"epip": zero, "smooth": zero, "consis": zero}
    use_photo = not cfg.disable_photoloss
    if use_photo:
        losses["photo"] = zero
    aux = LossAux({}, {}, {}, {})

    # every |epipolar residual| map of the step in one call: the networks'
    # normalized flow with its pixel scale, and the pose read in place
    keys = [(i, s) for s in cfg.scales for i in frame_ids]
    maps = []
    for i, s in keys:
        _, hs, ws, _ = colors[(0, s)].shape
        T = cam_T_cams[i]
        maps.append(EpipolarMap(flows[(i, s)].float(), (float(ws), float(hs)), inv_Ks[s], T[:, :3, :3], T[:, :3, 3]))
    with_grad = cfg.fine_tune_flow_motion or not cfg.use_pallas_epipolar
    maps_fn = epipolar_abs_residual_maps_reference if with_grad else epipolar_abs_residual_maps
    resids = dict(zip(keys, maps_fn(maps)))

    for s in cfg.scales:
        avg = float(2**s)
        tgt = colors[(0, s)]
        _, hs, ws, _ = tgt.shape

        m1 = mobiles[(frame_ids[0], s)]
        m2 = mobiles[(frame_ids[1], s)]
        min_mobile = torch.minimum(m1, m2)
        aux.min_mobiles[s] = min_mobile

        if not cfg.disable_consisloss:
            losses["consis"] = losses["consis"] + derivable_consistency_loss(m1, m2).mean() / avg

        gw = gauss[s] if gauss is not None else None
        for i in frame_ids:
            mobile = mobiles[(i, s)] if cfg.disable_min else min_mobile
            # pixel flow, only where it is read
            flow_px = flows[(i, s)].float() * scale_factor(hs, ws, device) if use_photo or s == 0 else None

            if not cfg.disable_smoothloss:
                losses["smooth"] = losses["smooth"] + smooth_loss(tgt, mobile) / avg

            if use_photo:
                photo, _, _, _ = photometric_loss(tgt, colors[(i, s)], flow_px, use_ssim=not cfg.no_ssim)
                losses["photo"] = losses["photo"] + photo / avg

            epip_loss, post, ori = epipolar_loss_terms(cfg, resids[(i, s)], mobile, instance_mask, gw)
            losses["epip"] = losses["epip"] + epip_loss / avg

            if s == 0:
                aux.epipolars[(i, 0)] = post
                aux.epipolar_ori[(i, 0)] = ori
                aux.flows[(i, 0)] = flow_px

    losses["loss"] = cfg.w_e * losses["epip"] + cfg.w_s * losses["smooth"] + cfg.w_c * losses["consis"]
    if use_photo:
        losses["loss"] = losses["loss"] + cfg.w_p * losses["photo"]
    return losses, aux
