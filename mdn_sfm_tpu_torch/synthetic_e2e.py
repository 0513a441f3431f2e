"""The two-stage MDN-SfM protocol rehearsed end to end on a synthetic
moving-object world with KNOWN ground truth — the port of
``tools/synthetic_e2e.py``.

    python -m mdn_sfm_tpu_torch.synthetic_e2e                      # on the card
    python -m mdn_sfm_tpu_torch.synthetic_e2e --device cpu --height 32 --width 64 --steps1 20 ...

The reference trains the mobile decoder against FROZEN flow and pose nets
from an earlier run (``log/v0/models/weights_0``); this rehearses that whole
workflow with no KITTI data and no pretrained weights:

* phase 1 trains FlowNet with the photometric loss alone
  (``fine_tune_flow_motion``, ``w_e=0``) on :func:`~.data.synthetic.moving_object_batch`
  worlds: the camera translates along x (uniform horizontal flow) and a
  square patch moves vertically. PoseNet is an ORACLE (its last conv's
  weight zeroed, its bias set so it outputs R = I, t = (1, 0, 0)). The
  nets are saved in the reference checkpoint layout;
* the calibration: |epipolar residual| quantiles of the trained flow and
  the oracle pose over the train stream (the reference's
  ``epipolar_statics`` protocol); their 95th percentile is the T/TG
  threshold;
* phase 2 loads flow and pose frozen from the phase-1 folder and trains a
  fresh MobileDecoder once per (mode, supervision source): DS/DC take the
  world's GT patch masks (``semantic_gt``) or the live Mask R-CNN fused into
  the step at ``d2_infer_scale`` N (``maskrcnn@N``), with the hand-set
  brightness detector (``masks/crafted.py``; needs ``--bright_world``);
* the scores: flow EPE before and after phase 1, and per row the mask
  accuracy / precision / recall / F1 / Dice against the known patch at
  ``--binary_threshold`` and at the best-F1 threshold of a sweep.

The JAX tool dispatches ``--k_steps`` steps at a time; here each step runs
on its own and the loss is read every ``k_steps`` steps, as the mean over
them (the JAX multi-step's metric). Prints one JSON line with the JAX
tool's keys. Runs on the card unless ``--device`` names another device. The
nets compute in bfloat16 on the card, as the JAX tool's do, and in float32
on the CPU, where PyTorch's bf16 autocast is slow and its conv backward does
not repeat bit for bit; ``--compute_dtype`` sets it otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import checkpoints as ckpt
from . import training as T
from .config import Config, Mode
from .data.augment import augment_batch
from .data.synthetic import moving_object_batch
from .metrics import compute_epe, get_quantitative_results
from .ops.epipolar import EpipolarMap, epipolar_abs_residual_maps
from .utils import resolve_device

# quantile levels of the calibration, per image and frame
CALIB_LEVELS = 100
CALIB_BATCHES = 8
CALIB_PERCENTILE = 95


def pose_oracle(models: T.ModelBundle) -> None:
    """Make the PoseNet head output the world's exact camera motion:
    axisangle 0, translation (1, 0, 0), whatever the input. The last conv's
    weight is zeroed and its bias set to the values before the head's 0.01
    scale: a crafted "pretrained" pose net for the synthetic world."""
    head = models.pose.decoder.pose_net[3]
    with torch.no_grad():
        head.weight.zero_()
        head.bias.copy_(torch.tensor([0.0, 0.0, 0.0, 100.0, 0.0, 0.0]))


def world_batches(n: int, batch_size: int, height: int, width: int, first_seed: int, world_kw: dict,
                  device: torch.device, with_masks: bool = False) -> list[dict]:
    """``n`` batches of fresh worlds, seeds ``first_seed`` … on ``device``;
    ``with_masks`` carries the worlds' GT patch masks as the DS/DC
    instance masks (the semantic-GT path)."""
    out = []
    for i in range(n):
        colors, K, mask, _, _ = moving_object_batch(batch_size, height, width, seed=first_seed + i, **world_kw)
        batch = {"colors_u8": torch.from_numpy(colors).to(device), "K": torch.from_numpy(K).to(device)}
        if with_masks:
            batch["instance_mask"] = torch.from_numpy(mask).to(device)
        out.append(batch)
    return out


def clean_forward(cfg: Config, models: T.ModelBundle, colors: dict) -> tuple[dict, dict]:
    """The un-augmented eval forward of both reference frames at scale 0:
    ({t: (B, H, W, 2) pixel flow}, {t: (B, H, W, 1) mobile}) as numpy."""
    tgt = colors[(0, 0)]
    h, w = tgt.shape[1:3]
    flows_px, mobiles = {}, {}
    for t in (-1, 1):
        flows, mobs, _, _, _ = T.eval_forward(cfg, models, tgt, colors[(t, 0)])
        flows_px[t] = flows[0].float().cpu().numpy() * np.array([w, h], np.float32)
        mobiles[t] = mobs[0].float().cpu().numpy()
    return flows_px, mobiles


@torch.no_grad()
def residual_quantiles(cfg: Config, models: T.ModelBundle, batch: dict, levels: int = CALIB_LEVELS) -> np.ndarray:
    """(2, levels, B): per reference frame (−1, +1) and image, the
    |epipolar residual| map's quantiles at ``levels`` evenly spaced levels
    (linear, as ``jnp.quantile``), from the un-augmented batch through the
    frozen flow and pose; both frames' maps in one call."""
    colors, inv_Ks, _ = augment_batch(cfg, batch["colors_u8"], batch["K"], train=False)
    tgt = colors[(0, 0)]
    h, w = tgt.shape[1:3]
    maps = []
    for t in (-1, 1):
        flows, _, _, _, cam = T.eval_forward(cfg, models, tgt, colors[(t, 0)])
        maps.append(EpipolarMap(flows[0].float(), (float(w), float(h)), inv_Ks[0], cam[:, :3, :3], cam[:, :3, 3]))
    q = torch.linspace(0.0, 1.0, levels, device=tgt.device)
    return np.stack([torch.quantile(e.reshape(e.shape[0], -1), q, dim=1).cpu().numpy()
                     for e in epipolar_abs_residual_maps(maps)])


def _compute_dtype(args) -> str:
    return args.compute_dtype or ("bfloat16" if torch.device(args.device).type == "cuda" else "float32")


def phase1_config(args) -> Config:
    """Photometric-only fine-tuning of flow and pose (the T mode's threshold
    post-processing: no max-normalizing divide)."""
    return Config(height=args.height, width=args.width, batch_size=args.batch_size, mode=Mode.T,
                  threshold=9.22, fine_tune_flow_motion=True, disable_photoloss=False, no_ssim=True,
                  w_p=1.0, w_e=0.0, w_s=0.0, w_c=0.0, w_d2_sim=0.0, learning_rate=args.lr1,
                  compute_dtype=_compute_dtype(args), log_dir=args.log_dir, v_save="e2e_v0").validate()


def phase2_config(args, mode: str, provider_spec: str | None, threshold: float, folder: str) -> Config:
    """One phase-2 row's config: TG with its step and LR multipliers; DS/DC
    with identity augmentation (the GT masks cannot follow a flip or a
    zoom-crop, and the provider rows stay comparable), DC with the BCE
    term at the reference weight; the reference's raw gauss sigmas."""
    live = provider_spec is not None and provider_spec.startswith("maskrcnn")
    return Config(
        height=args.height, width=args.width, batch_size=args.batch_size, mode=Mode(mode), alpha=0.55,
        w_e=1.0, w_s=0.1, w_c=0.5, w_d2_sim=0.05 if mode == "DC" else 0.0, threshold=threshold,
        gauss_sigma1=30.0, gauss_sigma2=120.0, disable_augment=mode in ("DS", "DC"),
        learning_rate=args.lr2 * (args.tg_lr_mult if mode == "TG" else 1.0), compute_dtype=_compute_dtype(args),
        log_dir=args.log_dir, load_weights_folder=folder, models_to_load=("flownet", "posenet"),
        **(dict(mask_provider="maskrcnn", d2_infer_scale=int(provider_spec.split("@")[1]), d2_max_instances=8)
           if live else {}),
    ).validate()


def parse_jobs(args) -> list[tuple[str, str | None]]:
    """The phase-2 rows [(mode, DS/DC supervision source or None)], the
    sources checked before any training: a mistyped ``--ds_providers`` must
    not fail after phase 1."""
    h, w = args.height, args.width
    modes = [m.strip().upper() for m in args.modes.split(",") if m.strip()]
    providers = [p.strip() for p in args.ds_providers.split(",") if p.strip()]
    for spec in providers:
        if spec == "semantic_gt":
            continue
        if not spec.startswith("maskrcnn@"):
            raise SystemExit(f"--ds_providers: unknown spec {spec!r} (use semantic_gt or maskrcnn@N)")
        try:
            scale = int(spec.split("@", 1)[1])
        except ValueError:
            raise SystemExit(f"--ds_providers: bad scale in {spec!r}")
        if (h * scale) % 64 or (w * scale) % 64:
            raise SystemExit(f"--ds_providers {spec!r}: inference shape {h * scale}x{w * scale} must be "
                             "divisible by 64 (FPN)")
    if (any(m in ("DS", "DC") for m in modes) and any(p != "semantic_gt" for p in providers)
            and not args.bright_world):
        raise SystemExit("--ds_providers maskrcnn@N needs --bright_world: the crafted brightness detector "
                         "only sees bright-on-dark objects")
    jobs: list = []
    for m in modes:
        jobs += [(m, p) for p in providers] if m in ("DS", "DC") else [(m, None)]
    return jobs


def _train(cfg: Config, models: T.ModelBundle, steps: int, k: int, batches_for, seed: int, device,
           provider=None, key: str = "loss", on_group=None) -> tuple[float, dict]:
    """``max(steps // k, 1)`` groups of ``k`` steps; returns the last group's
    mean ``key`` metric and what the steps did: steps, seconds (host clock,
    ending in a sync) and each kernel's launches (the epipolar kernel's
    maps too)."""
    opt = T.make_optimizer(cfg, models, steps_per_epoch=max(steps, 1))
    counts0 = _kernel_counts()
    t0 = time.perf_counter()
    step, last = 0, None
    for g in range(max(steps // k, 1)):
        total = None
        for batch in batches_for(g * k, k):
            metrics, _ = T.train_step(cfg, models, opt, batch, generator=T.step_generator(seed, step, device),
                                      provider=provider)
            total = metrics[key] if total is None else total + metrics[key]
            step += 1
        last = float(total) / k  # the loss's one read a group
        if on_group is not None:
            on_group(g, last)
    seconds = time.perf_counter() - t0
    return last, {"steps": step, "seconds": seconds,
                  **{k: v - counts0[k] for k, v in _kernel_counts().items()}}


def _kernel_counts() -> dict:
    from .ops import nms, roi_align

    return {"epipolar_launches": epipolar_abs_residual_maps.launches,
            "epipolar_maps": epipolar_abs_residual_maps.maps,
            "nms_launches": nms.nms.launches, "roi_align_launches": roi_align.multilevel_roi_align.launches}


def run(args, record: dict | None = None) -> dict:
    """The whole rehearsal; returns the JAX tool's result dict. ``record``,
    when given, receives what each phase did (steps, seconds, each kernel's
    launches), and phase 1's photometric loss, largest |flow| and flow EPE
    after each group (``phase1_groups``)."""
    device = resolve_device(args.device)
    h, w, bs = args.height, args.width, args.batch_size
    record = {} if record is None else record
    jobs = parse_jobs(args)
    results: dict = {}
    world_kw = dict(bg_shift=args.bg_shift, obj_shift=args.obj_shift, obj_size=args.obj_size or None,
                    bright_object=args.bright_world)

    # one fixed eval world, and a stream of training worlds
    ev_colors, ev_K, ev_mask, ev_flows, times = moving_object_batch(args.eval_batch, h, w, seed=10_000, **world_kw)

    def eval_colors(cfg):
        colors, _, _ = augment_batch(cfg, torch.from_numpy(ev_colors).to(device),
                                     torch.from_numpy(ev_K).to(device), train=False)
        return colors

    def flow_epe(flows_px):
        """Mean EPE over both reference frames, and the +1 frame's on the
        background and on the patch."""
        frame_of_t = {t: f for f, t in enumerate(times)}
        per, bg, obj = [], None, None
        for t, pred in flows_px.items():
            gt = ev_flows[:, frame_of_t[t]]
            ones = np.ones(gt.shape[:3], np.float32)
            per.append(np.mean([compute_epe(gt[b], pred[b], ones[b]) for b in range(len(gt))]))
            if t == 1:
                bg = np.mean([compute_epe(gt[b], pred[b], 1.0 - ev_mask[b]) for b in range(len(gt))])
                obj = np.mean([compute_epe(gt[b], pred[b], ev_mask[b]) for b in range(len(gt))])
        return float(np.mean(per)), float(bg), float(obj)

    def stream(first_seed, with_masks=False):
        return lambda start, n: world_batches(n, bs, h, w, first_seed + start, world_kw, device, with_masks)

    # ------------------------------------------------------------- phase 1
    cfg1 = phase1_config(args)
    models = T.build_models(cfg1, torch.Generator().manual_seed(args.seed), device)
    pose_oracle(models)
    colors0 = eval_colors(cfg1)
    f0, _ = clean_forward(cfg1, models, colors0)
    results["epe_init"], _, _ = flow_epe(f0)

    record["phase1_groups"] = []

    def photo_check(g, loss):
        # each group's photometric loss, and the eval world's largest |flow|
        # (px) and EPE: where a run that falls into the optimum below leaves
        flows_px, _ = clean_forward(cfg1, models, colors0)
        epe, max_flow = flow_epe(flows_px)[0], float(max(np.abs(f).max() for f in flows_px.values()))
        record["phase1_groups"].append({"photo": loss, "max_abs_flow_px": max_flow, "epe": epe})
        if args.verbose:
            print(f"phase1 group {g}: photo={loss:.6g} max|flow|={max_flow:.6g} px epe={epe:.6g}",
                  file=sys.stderr)
        # the photometric loss's degenerate optimum: flow that warps every
        # sample out of bounds makes the masked mean exactly 0 with no
        # gradient. Fail fast instead of training phase 2 on broken flow
        if loss == 0.0 and g >= 1:
            raise SystemExit(
                f"phase-1 photometric loss hit exactly 0 at group {g}: flow warped every sample out of "
                "bounds (degenerate optimum). The world is too hard for this lr/budget: reduce --obj_shift, "
                "raise texture contrast, or lower --lr1.")

    results["photo_final"], record["phase1"] = _train(cfg1, models, args.steps1, args.k_steps, stream(0),
                                                      args.seed + 1, device, key="photo", on_group=photo_check)

    # phase 1's nets in the reference layout: phase 2 reads them as the
    # reference reads log/v0
    folder = ckpt.weights_folder(args.log_dir, "e2e_v0", 0)
    ckpt.save_checkpoint(folder, {n: ckpt.to_host(m.state_dict())
                                  for n, m in T.modules_by_name(models).items() if n != "mobile_decoder"})
    f1, _ = clean_forward(cfg1, models, colors0)
    results["epe_trained"], results["epe_bg"], results["epe_obj"] = flow_epe(f1)

    # ------------------------------------------------------- calibration
    t0 = time.perf_counter()
    launches0 = epipolar_abs_residual_maps.launches
    qs = [residual_quantiles(cfg1, models, b) for b in world_batches(CALIB_BATCHES, bs, h, w, 50_000, world_kw, device)]
    calibrated = float(np.percentile(np.stack(qs).reshape(-1), CALIB_PERCENTILE))
    results["calibrated_threshold_p95"] = round(calibrated, 4)
    record["calibration"] = {"seconds": time.perf_counter() - t0, "batches": CALIB_BATCHES,
                             "epipolar_launches": epipolar_abs_residual_maps.launches - launches0}
    del models

    # ---------------------------------------------------- phase 2, per row
    providers_cache: dict = {}

    def get_provider(scale: int):
        from .masks.crafted import brightness_detector_state_dict
        from .masks.maskrcnn import MaskRCNNProvider

        if scale not in providers_cache:
            cfgp = Config(height=h, width=w, mode=Mode.DS, mask_provider="maskrcnn", d2_max_instances=8,
                          d2_infer_scale=scale, log_dir=args.log_dir).validate()
            providers_cache[scale] = MaskRCNNProvider(cfgp, device, weights=brightness_detector_state_dict())
        return providers_cache[scale]

    per_mode: dict = {}
    record["phase2"] = {}
    for mode, spec in jobs:
        provider = get_provider(int(spec.split("@")[1])) if spec and spec.startswith("maskrcnn") else None
        steps2 = args.steps2 * (args.tg_steps_mult if mode == "TG" else 1)
        cfg2 = phase2_config(args, mode, spec, calibrated, folder)
        models2 = T.build_models(cfg2, torch.Generator().manual_seed(args.seed + 2), device)
        ckpt.load_into(folder, T.modules_by_name(models2), ("flownet", "posenet"))
        tag = mode if spec in (None, "semantic_gt") else f"{mode}@{spec}"

        def log(g, loss, tag=tag):
            if args.verbose:
                print(f"[{tag}] phase2 group {g}: loss={loss:.4f}", file=sys.stderr)

        # semantic_gt rows carry the GT masks in the batch; maskrcnn@N rows
        # infer them inside the step
        needs_masks = mode in ("DS", "DC") and provider is None
        loss2, record["phase2"][tag] = _train(cfg2, models2, steps2, args.k_steps, stream(100_000, needs_masks),
                                              args.seed + 3, device, provider=provider, on_group=log)
        _, mobiles = clean_forward(cfg2, models2, eval_colors(cfg2))
        mobile = np.minimum(mobiles[-1], mobiles[1])[..., 0]  # min-fused, (B, H, W)

        # the effective budget: TG rows carry the step and LR multipliers
        row: dict = {"loss_final": loss2, "steps2": steps2, "lr2": cfg2.learning_rate}
        if spec is not None:
            row["provider"] = spec
        if provider is not None:
            # the live provider's own union masks against the GT patch
            sup = provider.union_masks_from_images(ev_colors[:, 0], h, w).cpu().numpy() > 0.5
            gt_b = ev_mask > 0
            row["sup_mask_iou"] = float((sup & gt_b).sum() / max((sup | gt_b).sum(), 1))
        row["sep"] = float(mobile[ev_mask > 0].mean() - mobile[ev_mask == 0].mean())
        acc, prec, rec, f1s, dice = get_quantitative_results((mobile >= args.binary_threshold).astype(np.float32),
                                                             ev_mask)
        row.update(accuracy=acc, precision=prec, recall=rec, f1=f1s, dice=dice,
                   binary_threshold=args.binary_threshold)
        # the README's operating points differ by mode: sweep, keep the best
        best = (-1.0, None)
        for thr in np.arange(0.01, 0.95, 0.01):
            f1t = get_quantitative_results((mobile >= thr).astype(np.float32), ev_mask)[3]
            if np.isfinite(f1t) and f1t > best[0]:
                best = (f1t, float(thr))
        row["best_f1"], row["best_f1_threshold"] = best
        per_mode[tag] = {kk: (round(vv, 4) if isinstance(vv, float) else vv) for kk, vv in row.items()}
        del models2

    results["modes"] = per_mode
    # the first row's fields at the top level, as the JAX tool reports them
    if per_mode:
        first = per_mode[next(iter(per_mode))]
        results.update({kk: first[kk] for kk in ("sep", "accuracy", "precision", "recall", "f1", "dice",
                                                  "best_f1", "best_f1_threshold")})
        results["loss2_final"] = first["loss_final"]
    return results


def build_parser() -> argparse.ArgumentParser:
    """The JAX tool's flags, with its defaults, plus ``--device`` and
    ``--compute_dtype``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--eval_batch", type=int, default=8)
    p.add_argument("--steps1", type=int, default=2000)
    p.add_argument("--steps2", type=int, default=1000)
    p.add_argument("--k_steps", type=int, default=50)
    p.add_argument("--lr1", type=float, default=3e-4)
    p.add_argument("--lr2", type=float, default=1e-4)
    p.add_argument("--tg_steps_mult", type=int, default=6,
                   help="phase-2 step multiplier for TG (gauss-scaling compensation)")
    p.add_argument("--tg_lr_mult", type=float, default=3.0, help="phase-2 lr multiplier for TG")
    p.add_argument("--binary_threshold", type=float, default=0.5)
    p.add_argument("--modes", default="SN,T,TG,DS,DC", help="comma-separated phase-2 training modes")
    p.add_argument("--ds_providers", default="semantic_gt",
                   help="comma-separated DS/DC supervision sources: semantic_gt and/or maskrcnn@N (the live "
                        "fused provider at d2_infer_scale=N; needs --bright_world)")
    p.add_argument("--bg_shift", type=int, default=2, help="background (camera) horizontal flow px/frame")
    p.add_argument("--obj_shift", type=int, default=3,
                   help="object vertical flow px/frame = the epipolar violation")
    p.add_argument("--obj_size", type=int, default=0, help="patch side px (0 = height//3)")
    p.add_argument("--bright_world", action="store_true",
                   help="dark background + bright patch (detectable by the crafted brightness Mask R-CNN)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", default=os.path.join("log", "e2e"))
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    p.add_argument("--compute_dtype", default="", choices=("", "bfloat16", "float32"),
                   help="default: bfloat16 on the card (the JAX tool's), float32 on the CPU")
    return p


def main(argv=None) -> None:
    print(json.dumps(run(build_parser().parse_args(argv))))


if __name__ == "__main__":
    main()
