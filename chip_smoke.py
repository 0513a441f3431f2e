#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds every kernel from ``mdn_sfm_tpu_torch/csrc``, holds each against its
plain PyTorch version at the shapes the main path gives it, drives the main
path — the TG training step at 640×192, batch 4, bf16, ResNet18 flow/pose
nets with random weights from a seed — through ``training.train_step``,
checks a small f32 step on the card against the same step on the CPU,
drives the same path through the ``Trainer`` (an epoch with checkpoints, a
stopped run resumed with ``resume="auto"``, a checkpoint loaded back), and
runs the four eval CLIs on a KITTI-layout world at KITTI's frame size
(640×192, bf16, batch 8; evaluate_mix and evaluate_flow through the kernel),
with a small f32 world on the card against the CPU, and drives DS and DC
training with the live Mask R-CNN R50-FPN fused into the step at 384×1280
(its NMS and ROIAlign kernels held against their plain versions on the
inputs the step and the 640×2048 backend give them), a DS run on masks the
backend precomputes, and a small f32 DS step on the card against the CPU;
and the step options at the main path's width (fine-tuning flow and pose,
with remat and with accum_steps=2; train-mode BN with the frozen nets), a
device trace of the fine-tune step, small f32 option steps on the card
against the CPU, a skipped non-finite step with no added host sync, the
Trainer fine-tuning (checkpoints of the three nets, an exact resume), and a
short synthetic two-stage rehearsal (phase 1 photometric fine-tuning, the
calibration, phase 2 in TG and in DS on GT masks and on the live Mask R-CNN).

Prints one JSON object per phase, the card's name and power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
not 0 and no result line is printed. Without CUDA, or without the package
beside it, it fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

# Main path (bench.py's default cell): TG, 640×192, batch 4.
HEIGHT, WIDTH, BATCH = 192, 640, 4
SCALES = (0, 1, 2, 3)
TRAIN_STEPS = 30        # timed steps of the main path (≥ 20)
WARMUP_STEPS = 3
KERNEL_REPS = 100       # launches per kernel and shape in a timing (≥ 50)
KERNEL_WARMUP = 20
COLD_COPIES = 8         # copies of a step's epipolar inputs, 125 MB in all, cycled
TRAINER_STEPS = 12      # the Trainer phase: one epoch of this many steps
SAVE_EVERY = 4          # its save_frequency
STOP_AFTER = 5          # run B stops after this many steps; B2 resumes it
LR = 1e-4               # Config.learning_rate
# B2 against A: the same batches and draws, but the backward of the
# reflection pads adds with atomics on the card, so the sums differ in the
# last bits; Adam's lr·m/sqrt(v) can then flip sign only where a gradient
# sits at that noise, which moves a param by at most 2·lr a resumed step.
# This caps the largest difference; it cannot tell a broken resume apart.
RESUME_PARAM_ATOL = 2 * LR * (TRAINER_STEPS - STOP_AFTER)
# The mean |difference| over the decoder's params does: it sits between
# B2's (the atomics' noise) and that of a control resumed with Adam's μ and
# ν zeroed, both measured in this phase (PERF.md gives the readings)
RESUME_MEAN_ATOL = 5e-6

# Phase 7, the eval CLIs at the main path's width: a KITTI-2015-layout world
# at KITTI's frame size, two batches of Config.eval_batch_size
EVAL_SAMPLES = 16
EVAL_BATCH = 8
KITTI_H, KITTI_W = 375, 1242
ODOMETRY = (("09", 5), ("10", 4))  # sequences and their frames: 3 + 2 snippets of 3
EVAL_THRESHOLD = 0.3  # the README's TG threshold; seed 0's random nets predict on both sides of it
# the f32 check on the card against the CPU, on a world of the CPU tests'
# size, with their tolerances (tests/test_torch_eval_{mix,flow_pose}.py)
SMALL_SAMPLES, SMALL_FRAME, SMALL_NET = 2, (48, 96), (32, 96)
EVAL_PRED_ATOL = 1e-4   # the upsampled mobile maps (f32 forward tolerance)
EVAL_MARGIN = 1e-3      # no upsampled prediction lies this near a threshold
EVAL_ROW_ATOL = 1e-6    # metric rows at such thresholds
EVAL_EPE_RTOL = 1e-4
EVAL_POSE_ATOL = 1e-5

# Phase 8, DS/DC with the Mask R-CNN R50-FPN fused into the step: the live
# provider at d2_infer_scale 2 (384×1280), random weights from seed 0, at
# the reference's score threshold and at a low one that makes detections
DS_STEPS = 10           # timed steps a run
DS_WARMUP = 2
D2_THRESHOLDS = (0.3, 0.05)
BACKEND_FRAMES = 8      # synthetic target frames masked by the 640×2048 backend
PRECOMPUTED_STEPS = 4   # the DS Trainer run on those masks
# kernel vs plain: NMS must be identical; ROIAlign rounds op by op as the
# plain version does (--fmad=false), so f32 within a few ulp of the largest
# value and bf16 within one bf16 rounding of it
ROI_REL_TOL = {"float32": 1e-6, "bfloat16": 2.0**-8}
# work counted for the bounds: one IoU (areas, intersection, union, divide)
# and one ROIAlign output value (4 sub-bins × (8 mul, 3 add, 2 sub, 1 acc),
# the mean) in f32 operations
NMS_IOU_FLOP = 18
ROI_FLOP_PER_OUTPUT = 57
# detections of a small f32 Mask R-CNN on the card against the CPU, on valid
# slots: tests/test_maskrcnn.py's JAX-against-torch tolerances
DET_SCORE_ATOL, DET_BOX_ATOL, DET_MASK_ATOL = 5e-4, 0.1, 2e-3

# Phase 9, the step options: each configuration at the main path's width,
# and the rehearsal (tools/synthetic_e2e.py's round-5 world at 64×128, B=4)
OPTION_STEPS = 20       # timed steps a configuration (≥ 20)
OPTION_WARMUP = 3
OPTION_CONFIGS = (
    ("fine_tune", dict(fine_tune_flow_motion=True)),
    ("fine_tune_remat", dict(fine_tune_flow_motion=True, remat=True)),
    ("fine_tune_accum2", dict(fine_tune_flow_motion=True, accum_steps=2)),
    ("bn_train_frozen_nets", dict(bn_frozen_eval=False)),
)
TRACE_STEPS = 5         # fine-tune steps in the device trace
# f32 option steps on the card against the CPU: phase 5's step-0 bound. With
# fine-tuning and train-mode BN, step 1 takes the change that one ulp of the
# flow params makes on the CPU (tests/test_torch_step_options.py::
# test_fine_tune_steps_amplify_one_ulp, measured 2.6e-3): Adam's first update
# amplifies rounding through layer4's batch statistics, and the same holds
# with accum_steps=2, whose microbatches' statistics are smaller still
OPTION_RTOLS = (1e-5, 3e-3)
REHEARSAL_ARGV = ["--height", "64", "--width", "128", "--batch_size", "4", "--eval_batch", "8",
                  "--steps1", "300", "--steps2", "200", "--k_steps", "50", "--tg_steps_mult", "3",
                  "--tg_lr_mult", "1.0", "--modes", "TG,DS", "--ds_providers", "semantic_gt,maskrcnn@2",
                  "--bright_world", "--obj_shift", "6", "--obj_size", "16"]
EPE_CUT = 0.7           # phase 1 must bring the eval flow EPE under this share of its start

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# the epipolar map per pixel: F·p1 (12), p2 (2), l·p2 (4), the norm (6),
# divide + abs (2)
EPI_FLOP_PER_PX = 26
# kernel vs plain: the kernel is built with --fmad=false and rounds op by op
# as the plain version does; allow a few ulp of the map's largest value
EPI_REL_TOL = 1e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def call_ms(fn, reps: int, warmup: int) -> float:
    """Median device span of one call of ``fn`` in ms: CUDA events around
    each call, so host work between its launches counts, as the main path
    pays it."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int, warmup: int, replays: int = 5) -> float:
    """Device time of one call of ``fn`` in ms with the host out of the way:
    ``reps`` calls captured in a CUDA graph, replayed; the median replay over
    ``reps``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def epi_bound_ms(maps) -> tuple[float, float]:
    """(bytes, operations) times in ms for the maps: each flow read once, each
    map written once and the pose tables (inv_K, R, t: 21 floats an image),
    against the maps' f32 operations. The least time the card could take is
    the larger of the two."""
    px = sum(m.flow[..., 0].numel() for m in maps)
    images = sum(m.flow.shape[0] for m in maps)
    nbytes = px * (2 * 4 + 4) + images * (9 + 9 + 3) * 4
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * px * EPI_FLOP_PER_PX / PEAK_F32_FLOP_PER_S


def bound_of(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_maps(E, maps, what: str, want_vec: bool | None) -> float:
    """The many-map kernel against its plain version, map by map, within
    EPI_REL_TOL of each map's largest value; the largest abs error."""
    import torch

    vec = [E.vector_layout(m.flow) for m in maps]
    got = E.epipolar_abs_residual_maps(maps)
    want = E.epipolar_abs_residual_maps_reference(maps)
    torch.cuda.synchronize()
    worst = 0.0
    for m, v, g, r in zip(maps, vec, got, want):
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        ok = bool(torch.isfinite(g).all()) and err <= EPI_REL_TOL * scale and (want_vec is None or v == want_vec)
        emit({"phase": "kernel_check", "kernel": "epipolar_abs_residual_maps", "maps": what,
              "shape": list(m.flow.shape[:3]), "scale": list(m.scale), "vector_path": v,
              "max_abs_err": err, "max_abs_ref": scale, "rel_err": err / scale, "tol_rel": EPI_REL_TOL, "ok": ok})
        if not ok:
            raise AssertionError(f"epipolar maps kernel disagrees with its plain version: {what} {tuple(m.flow.shape)}")
        worst = max(worst, err)
    return worst


def kernel_phase(smi: str) -> dict:
    """Phase 3: the kernel against its plain version, then timing. Its
    tensors die on return, so the main path's peak memory is its own."""
    import torch

    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import epi_inputs, ragged_maps, step_maps

    # 3a. one map a launch (the one-map entry, pixel flow, scale 1) at the
    # main path's shapes, dense NHWC and the permuted NCHW view
    shapes = [(BATCH, HEIGHT >> s, WIDTH >> s) for s in SCALES]
    shapes += [(2 * BATCH, h, w) for _, h, w in shapes] + [(1, 37, 83)]
    worst = 0.0
    for i, (b, h, w) in enumerate(shapes):
        for layout in ("nhwc", "nchw_view"):
            args = epi_inputs(b, h, w, seed=i, nchw_view=layout == "nchw_view")
            got = E.epipolar_abs_residual(*args)
            want = E.epipolar_abs_residual_reference(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= EPI_REL_TOL * scale
            emit({"phase": "kernel_check", "kernel": "epipolar_abs_residual", "shape": [b, h, w],
                  "layout": layout, "max_abs_err": err, "max_abs_ref": scale,
                  "rel_err": err / scale, "tol_rel": EPI_REL_TOL, "ok": ok})
            if not ok:
                raise AssertionError(
                    f"epipolar kernel disagrees with its plain version at {(b, h, w)} {layout}")
            worst = max(worst, err)

    # 3b. a step's 8 maps in one launch, normalized flow with its scale: as
    # the loss hands them over (vector path), dense (vector path), as NCHW
    # views (scalar path); and ragged shapes mixing both paths
    for i, (layout, vec) in enumerate((("loss", True), ("dense", True), ("nchw_view", False))):
        worst = max(worst, check_maps(E, step_maps(layout, BATCH, HEIGHT, WIDTH, seed=10 + i), layout, vec))
    worst = max(worst, check_maps(E, ragged_maps(seed=20), "ragged", None))

    # 3c. timing on the main path's layout. The bare launch (table prebuilt):
    # 8 one-map launches (A) against 1 eight-map launch (B), in turns A B B A,
    # as device time of KERNEL_REPS launches in a CUDA graph (flow in L2);
    # B with its flow cold; the plain version; and the wrapper's call span as
    # the main path pays it (table built and checked on the host each call)
    maps = step_maps("loss", BATCH, HEIGHT, WIDTH, seed=100)
    dev = maps[0].flow.device
    out8 = torch.empty(E.out_offsets(maps)[1], device=dev)
    table8 = E.build_table(maps, out8)
    outs1 = [torch.empty(E.out_offsets([m])[1], device=dev) for m in maps]
    tables1 = [E.build_table([m], o) for m, o in zip(maps, outs1)]

    def eight_launches():
        for t in tables1:
            E.launch(t, dev)

    def one_launch():
        E.launch(table8, dev)

    turns = {"A1": device_ms(eight_launches, KERNEL_REPS, KERNEL_WARMUP),
             "B1": device_ms(one_launch, KERNEL_REPS, KERNEL_WARMUP),
             "B2": device_ms(one_launch, KERNEL_REPS, KERNEL_WARMUP),
             "A2": device_ms(eight_launches, KERNEL_REPS, KERNEL_WARMUP)}
    step_kernel_ms = (turns["B1"] + turns["B2"]) / 2
    eight_launch_ms = (turns["A1"] + turns["A2"]) / 2
    # cold, in a CUDA graph as the warm time is taken: B over COLD_COPIES
    # copies of the step's inputs in turn. Between two launches on one copy
    # the others read and write about 110 MB, more than the 50 MB L2, so each
    # launch finds its flow in device memory. (An event pair around a single
    # replay after a flush would time the replay's fixed cost too.)
    cold = []
    for k in range(COLD_COPIES):
        c = step_maps("loss", BATCH, HEIGHT, WIDTH, seed=200 + k)
        o = torch.empty(E.out_offsets(c)[1], device=dev)
        cold.append((E.build_table(c, o), c, o))  # the table holds raw pointers: keep its tensors
    turn = [0]

    def rotating_launch():
        E.launch(cold[turn[0] % COLD_COPIES][0], dev)
        turn[0] += 1

    cold_ms = device_ms(rotating_launch, KERNEL_REPS, KERNEL_WARMUP)
    del cold
    # yardstick, used nowhere in the port: one PyTorch elementwise pass that
    # moves the same bytes (reads the step's 8 flows as one (P, 2) tensor,
    # writes P floats), warm and over COLD_COPIES copies
    npx = sum(m.flow[..., 0].numel() for m in maps)
    same = [(torch.randn(npx, 2, device=dev), torch.empty(npx, device=dev)) for _ in range(COLD_COPIES)]
    same_bytes_ms = device_ms(lambda: torch.add(same[0][0][:, 0], same[0][0][:, 1], out=same[0][1]),
                              KERNEL_REPS, KERNEL_WARMUP)
    turn[0] = 0

    def rotating_same_bytes():
        x, o = same[turn[0] % COLD_COPIES]
        torch.add(x[:, 0], x[:, 1], out=o)
        turn[0] += 1

    same_bytes_cold_ms = device_ms(rotating_same_bytes, KERNEL_REPS, KERNEL_WARMUP)
    del same
    step_plain_ms = device_ms(lambda: E.epipolar_abs_residual_maps_reference(maps), KERNEL_REPS, KERNEL_WARMUP)
    step_call_ms = call_ms(lambda: E.epipolar_abs_residual_maps(maps), KERNEL_REPS, KERNEL_WARMUP)
    t_bytes, t_ops = epi_bound_ms(maps)
    step_bound_ms, step_bound_by = bound_of(t_bytes, t_ops)
    warm_share = step_bound_ms / step_kernel_ms
    emit({"phase": "kernel_time", "kernel": "epipolar_abs_residual_maps",
          "work": "the 8 maps of a train step, as the loss hands them over",
          "one_launch_ms_turns": [turns["B1"], turns["B2"]],
          "eight_one_map_launches_ms_turns": [turns["A1"], turns["A2"]],
          "ms": step_kernel_ms, "eight_launches_ms": eight_launch_ms,
          "cold_ms": cold_ms, "cold_copies": COLD_COPIES,
          "same_bytes_torch_pass_ms": same_bytes_ms, "same_bytes_torch_pass_cold_ms": same_bytes_cold_ms,
          "plain_ms": step_plain_ms, "wrapper_call_ms": step_call_ms,
          "bound_ms": step_bound_ms, "bound_by": step_bound_by,
          "share_of_bound_warm": warm_share, "share_of_bound_cold": step_bound_ms / cold_ms,
          "note": ("warm share above 1.0: the flow came from L2, not device memory; the bound is "
                   "against HBM" if warm_share > 1.0 else "shares against the HBM bound"),
          "reps": KERNEL_REPS, "card": smi})
    return {"max_abs_err": worst, "ms": step_kernel_ms, "cold_ms": cold_ms, "plain_ms": step_plain_ms,
            "bound_ms": step_bound_ms, "bound_by": step_bound_by, "wrapper_call_ms": step_call_ms,
            "eight_launches_ms": eight_launch_ms}


def _mobile_and_adam(trainer) -> tuple[dict, dict]:
    """CPU copies of the trainer's mobile-decoder params and Adam state."""
    from mdn_sfm_tpu_torch import checkpoints as ckpt

    return ckpt.to_host(trainer.models.mobile.state_dict()), ckpt.to_host(trainer.opt.state_dict())


def _adam_equal(a: dict, b: dict) -> bool:
    import torch

    return sorted(a["state"]) == sorted(b["state"]) and all(
        torch.equal(a["state"][i][k], b["state"][i][k])
        for i in a["state"] for k in ("step", "exp_avg", "exp_avg_sq"))


def _params_equal(a: dict, b: dict) -> bool:
    import torch

    return sorted(a) == sorted(b) and all(torch.equal(a[k], v) for k, v in b.items())


def _drift(params: dict, ref: dict) -> tuple[float, float]:
    """(largest, mean) |difference| over every param."""
    import torch

    d = torch.cat([(params[k] - v).abs().flatten() for k, v in ref.items()])
    return float(d.max()), float(d.mean())


def trainer_phase(smi: str, bare_step_ms: float) -> None:
    """Phase 6: the Trainer at full width (TG, 640×192, batch 4, bf16,
    synthetic): run A, one epoch of TRAINER_STEPS steps with a checkpoint
    every SAVE_EVERY; run B, the same run stopped after STOP_AFTER steps by
    the flag the SIGTERM handler sets; run B2, ``resume="auto"`` from B's
    checkpoint to the end, whose loaded params and Adam state must equal
    B's at its stop bit for bit, and which must take A's batches and land
    within RESUME_PARAM_ATOL (largest) and RESUME_MEAN_ATOL (mean) of A's
    params; a control C, resumed as B2 but with Adam's μ and ν zeroed, must
    land beyond RESUME_MEAN_ATOL; A's last checkpoint loaded back into
    fresh models and a fresh Adam, which must equal A's exactly."""
    import shutil
    import tempfile

    import torch

    from mdn_sfm_tpu_torch import checkpoints as ckpt
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="mdn_trainer_") as tmp:
        def config(v_save: str, **kw) -> Config:
            return Config(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode.TG, threshold=9.22,
                          w_d2_sim=0.0, compute_dtype="bfloat16", num_epochs=1,
                          limit_train_samples=BATCH * TRAINER_STEPS, save_frequency=SAVE_EVERY,
                          log_frequency=1, num_workers=2, log_dir=os.path.join(tmp, "log"),
                          other_files_path=os.path.join(tmp, "files"), v_save=v_save, **kw).validate()

        # run A, uninterrupted; its every step reads the loss, so its step
        # times hold the device's work
        E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
        tA = Trainer(config("vA"), synthetic=True, device="cuda")
        # what run A spends outside its steps: each wait for the loader's
        # next batch, and each TensorBoard log (with images at batch 0)
        waits, logs, log_args = [], [], []
        iter_batches, log = tA.train_loader.iter_batches, tA.log

        def timed_batches(skip=0):
            it = iter_batches(skip)
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                if item is None:
                    return
                waits.append(time.perf_counter() - t0)
                yield item

        def timed_log(metrics, aux, log_image=False):
            t0 = time.perf_counter()
            log(metrics, aux, log_image=log_image)
            logs.append(time.perf_counter() - t0)
            log_args[:] = [metrics, aux]

        tA.train_loader.iter_batches, tA.log = timed_batches, timed_log
        tA.train()
        launches, nmaps = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps
        t0 = time.perf_counter()
        log(*log_args, log_image=True)  # a second image log, warm
        warm_log_s = time.perf_counter() - t0
        models_dir = os.path.join(tmp, "log", "vA", "models")
        n_saves = TRAINER_STEPS // SAVE_EVERY + 1  # every SAVE_EVERY steps and once at the end
        layout_ok = os.path.exists(os.path.join(models_dir, "opt.json")) and all(
            os.path.exists(os.path.join(ckpt.weights_folder(os.path.join(tmp, "log"), "vA", i), f))
            for i in range(n_saves) for f in ("mobile_decoder.pth", "adam.pth", "meta.json"))
        losses_ok = (len(tA.step_log) == TRAINER_STEPS
                     and all(math.isfinite(loss) for _, _, loss in tA.step_log))
        params_A, adam_A = _mobile_and_adam(tA)
        finite = all(bool(torch.isfinite(v).all()) for v in params_A.values())

        # run B, stopped after STOP_AFTER steps, then B2 resumed to the end
        tB = Trainer(config("vB"), synthetic=True, device="cuda")
        inner = tB.step_fn

        def stop_after(batch, generator):
            out = inner(batch, generator)
            if len(tB.sample_history) == STOP_AFTER:
                tB._stop_requested = True  # what the SIGTERM handler sets
            return out

        tB.step_fn = stop_after
        tB.train()
        params_stop, adam_stop = _mobile_and_adam(tB)
        # the control resumes from a copy of B's checkpoints
        shutil.copytree(os.path.join(tmp, "log", "vB", "models"), os.path.join(tmp, "log", "vC", "models"))
        tB2 = Trainer(config("vB", resume="auto"), synthetic=True, device="cuda")
        start_step = tB2.start_step
        params_loaded, adam_loaded = _mobile_and_adam(tB2)
        loaded_exact = (_params_equal(params_loaded, params_stop) and _adam_equal(adam_loaded, adam_stop)
                        and tB2.opt.count == tB.opt.count == STOP_AFTER)
        tB2.train()
        params_B, _ = _mobile_and_adam(tB2)
        same_batches = tB.sample_history + tB2.sample_history == tA.sample_history
        diff, mean_diff = _drift(params_B, params_A)

        tC = Trainer(config("vC", resume="auto"), synthetic=True, device="cuda")
        for t in tC.opt.mu + tC.opt.nu:
            t.zero_()
        tC.train()
        control_diff, control_mean = _drift(_mobile_and_adam(tC)[0], params_A)
        resume_ok = (start_step == STOP_AFTER and loaded_exact and same_batches
                     and diff <= RESUME_PARAM_ATOL and mean_diff <= RESUME_MEAN_ATOL < control_mean
                     and tB2.opt.count == tA.opt.count)

        # A's last checkpoint back into fresh models and a fresh Adam
        last = ckpt.weights_folder(os.path.join(tmp, "log"), "vA", ckpt.latest_weights_idx(
            os.path.join(tmp, "log"), "vA"))
        fresh = T.build_models(tA.cfg, device="cuda")
        opt = T.make_optimizer(tA.cfg, fresh, tA.steps_per_epoch)
        merged, adam, step = ckpt.load_checkpoint(last, {"mobile_decoder": fresh.mobile.state_dict()},
                                                  ("mobile_decoder",), load_adam=True)
        fresh.mobile.load_state_dict(merged["mobile_decoder"])
        opt.load_state_dict(adam)
        loaded_params, loaded_adam = ckpt.to_host(fresh.mobile.state_dict()), ckpt.to_host(opt.state_dict())
        load_ok = (step == TRAINER_STEPS and opt.count == tA.opt.count
                   and _params_equal(loaded_params, params_A)
                   and _adam_equal(loaded_adam, adam_A))

        step_s = [s for _, s, _ in tA.step_log]
        step_ms = statistics.median(step_s) * 1e3
        # end to end: run A's wall clock from its first batch request to its
        # last loss read, over its steps
        wall_ms = (tA.last_loss_read - tA.loop_start) * 1e3 / TRAINER_STEPS
        # the host copies of the saves inside the loop (not the one after its last step)
        copies = sum(s["host_copy_s"] for s in tA.save_seconds if s["step"] < TRAINER_STEPS)
        rest_ms = wall_ms * TRAINER_STEPS - 1e3 * (sum(step_s) + sum(waits) + sum(logs) + copies)
        saves = [s for s in tA.save_seconds if s["async"]]
        final = [s for s in tA.save_seconds if not s["async"]]
        ok = (layout_ok and losses_ok and finite and resume_ok and load_ok
              and launches == TRAINER_STEPS and nmaps == 8 * TRAINER_STEPS)
        emit({"phase": "trainer", "mode": "TG", "height": HEIGHT, "width": WIDTH, "batch": BATCH,
              "compute_dtype": "bfloat16", "steps": TRAINER_STEPS, "save_frequency": SAVE_EVERY,
              "checkpoints_layout_ok": layout_ok, "params_finite": finite,
              "epipolar_launches": launches, "expected_launches": TRAINER_STEPS,
              "epipolar_maps": nmaps, "expected_maps": 8 * TRAINER_STEPS,
              "trainer_wall_ms_per_step": wall_ms, "trainer_wall_examples_per_s": BATCH / (wall_ms / 1e3),
              "trainer_median_step_ms": step_ms, "trainer_median_examples_per_s": BATCH / (step_ms / 1e3),
              "trainer_step_ms": [1e3 * s for s in step_s],
              "loader_wait_ms": [1e3 * s for s in waits], "log_ms": [1e3 * s for s in logs],
              "warm_image_log_ms": 1e3 * warm_log_s, "wall_rest_ms": rest_ms,
              "trainer_step_ms_run_B": [1e3 * s for _, s, _ in tB.step_log],
              "trainer_step_ms_run_B2": [1e3 * s for _, s, _ in tB2.step_log],
              "losses_run_B2": [loss for _, _, loss in tB2.step_log],
              "losses_control": [loss for _, _, loss in tC.step_log],
              "losses": [loss for _, _, loss in tA.step_log], "losses_finite": losses_ok,
              "bare_train_step_median_ms": bare_step_ms,
              "checkpoint_host_copy_ms": [1e3 * s["host_copy_s"] for s in tA.save_seconds],
              "checkpoint_write_ms_async": [1e3 * s["write_s"] for s in saves],
              "checkpoint_write_ms_final": [1e3 * s["write_s"] for s in final],
              "resume_start_step": start_step, "resume_loaded_exact": loaded_exact,
              "resume_same_batches": same_batches,
              "resume_max_param_abs_diff": diff, "resume_param_atol": RESUME_PARAM_ATOL,
              "resume_mean_param_abs_diff": mean_diff, "resume_mean_atol": RESUME_MEAN_ATOL,
              "control_max_param_abs_diff": control_diff, "control_mean_param_abs_diff": control_mean,
              "load_back_exact": load_ok, "card": smi, "ok": ok})
        if not ok:
            raise AssertionError("the Trainer phase failed (see its line)")


def write_eval_world(base: str, n: int, frame_hw: tuple[int, int], net_hw: tuple[int, int], **cfg_kw):
    """A KITTI-2015-layout world under ``base`` (``n`` samples with GT flow,
    semantics and GT masks; odometry sequences 09 and 10) written by
    ``tests/fixtures.py``, and random weights from seed 0 in the reference
    ``.pth`` layout (flow and pose under v0, the mobile decoder under v1);
    returns the eval Config that reads it."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from fixtures import make_gt_masks, make_kitti2015, make_odometry

    from mdn_sfm_tpu_torch import checkpoints as ckpt
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config

    root, log_dir, out_dir = (os.path.join(base, d) for d in ("kitti", "log", "out"))
    make_kitti2015(root, n=n, h=frame_hw[0], w=frame_hw[1])
    make_gt_masks(os.path.join(out_dir, "gt"), n=n, h=frame_hw[0], w=frame_hw[1])
    for seq, frames in ODOMETRY:
        make_odometry(root, seq, n_frames=frames, h=frame_hw[0], w=frame_hw[1])
    kw = dict(height=net_hw[0], width=net_hw[1], data_root=root, raw_dataset_dir=root, log_dir=log_dir,
              eval_out_dir=out_dir, gt_mask_path=os.path.join(out_dir, "gt"),
              load_weights_folder=ckpt.weights_folder(log_dir, "v0", 0), version="v1", idx=0,
              eval_num_samples=n, eval_batch_size=EVAL_BATCH, binary_threshold=EVAL_THRESHOLD,
              pred_errors=True, save_pred_masks=True, save_pred_motions=True, save_pred_poses=True)
    cfg = Config(**{**kw, **cfg_kw}).validate()
    nets = T.modules_by_name(T.build_models(cfg, torch.Generator().manual_seed(0), "cpu"))
    sd = {k: ckpt.to_host(m.state_dict()) for k, m in nets.items()}
    ckpt.save_checkpoint(cfg.load_weights_folder, {k: sd[k] for k in ("flownet", "posenet")})
    ckpt.save_checkpoint(ckpt.weights_folder(log_dir, "v1", 0), {"mobile_decoder": sd["mobile_decoder"]})
    return cfg


def eval_outputs(cfg) -> dict[str, list[str]]:
    """Each CLI's output files, by the paths the root CLIs write."""
    from mdn_sfm_tpu_torch import checkpoints as ckpt

    n = cfg.eval_num_samples
    mask_dir = os.path.join(ckpt.weights_folder(cfg.log_dir, cfg.version, cfg.idx), "predictions", "mobile",
                            cfg.eval_name)
    flow_dir = os.path.join(cfg.eval_out_dir, "flow", cfg.eval_name)
    return {
        "evaluate_mix": [os.path.join(cfg.eval_out_dir, "mobile", f"masks_{cfg.version}_{cfg.idx}", f"{j}.png")
                         for j in range(n)],
        "evaluate_mask": [os.path.join(mask_dir, f"{j}.png") for j in range(n)],
        "evaluate_flow": [os.path.join(flow_dir, f"{j}.png") for j in range(n)] + [os.path.join(flow_dir, "result.txt")],
        "evaluate_pose": [os.path.join(cfg.eval_out_dir, "pose", f) for f in ("poses.npy", "result.txt")],
    }


def _thresholds_with_margin(values, k: int = 4) -> list[float]:
    """Midpoints of the k widest gaps between the sorted values that are
    wider than 2·EVAL_MARGIN."""
    import numpy as np

    values = np.sort(values)
    gaps = np.diff(values)
    return sorted(float(values[i] + gaps[i] / 2) for i in np.argsort(gaps)[::-1][:k] if gaps[i] > 2 * EVAL_MARGIN)


def eval_cuda_vs_cpu(base: str) -> dict:
    """evaluate_mix, evaluate_flow and evaluate_pose at f32 on a small world,
    on the card and on the CPU: the upsampled mobile maps, the metric rows at
    thresholds no prediction lies near, the mean EPEs, ATE/RE and the poses."""
    import dataclasses

    import numpy as np
    import torch

    from mdn_sfm_tpu_torch import evaluate_flow, evaluate_mix, evaluate_pose
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.data.eval_datasets import KittiSegDataset

    cfg = write_eval_world(base, SMALL_SAMPLES, SMALL_FRAME, SMALL_NET, compute_dtype="float32",
                           save_pred_masks=False, save_pred_motions=False)
    preds = {}
    for dev in ("cpu", "cuda"):
        models = T.load_eval_models(cfg, dev)
        data = KittiSegDataset(cfg.data_root, cfg.height, cfg.width, n=cfg.eval_num_samples)
        preds[dev] = np.concatenate([
            evaluate_mix.at_resolution(mobile, evaluate_mix.read_gt_mask(cfg.gt_mask_path, j).shape).ravel()
            for j, _, mobile, _, _ in evaluate_mix.predict(cfg, models, data, torch.device(dev))])
    pred_err = float(np.abs(preds["cuda"] - preds["cpu"]).max())
    thresholds = _thresholds_with_margin(np.concatenate([preds["cpu"], preds["cuda"]]))
    if not thresholds:
        raise AssertionError("the small world's predictions leave no threshold with a margin")
    cfg = dataclasses.replace(cfg, binary_threshold=thresholds[0])
    runs = {}
    for dev in ("cpu", "cuda"):
        c = dataclasses.replace(cfg, eval_out_dir=os.path.join(base, f"out_{dev}"))
        row, rows = evaluate_mix.evaluate(c, thresholds, device=dev)
        epe = evaluate_flow.evaluate(c, device=dev)
        pose = evaluate_pose.evaluate(c, device=dev)
        runs[dev] = (np.concatenate([row] + [rows[t] for t in thresholds]), epe, np.stack(pose),
                     np.load(os.path.join(c.eval_out_dir, "pose", "poses.npy")))
    (rows_c, epe_c, pose_c, poses_c), (rows_g, epe_g, pose_g, poses_g) = runs["cpu"], runs["cuda"]
    rows_ok = bool(np.array_equal(np.isnan(rows_c), np.isnan(rows_g))) and bool(
        np.allclose(rows_g, rows_c, atol=EVAL_ROW_ATOL, rtol=0, equal_nan=True))
    epe_rel = float(np.max(np.abs(epe_g - epe_c) / np.abs(epe_c)))
    pose_err = max(float(np.abs(pose_g - pose_c).max()), float(np.abs(poses_g - poses_c).max()))
    ok = (pred_err <= EVAL_PRED_ATOL and rows_ok and epe_rel <= EVAL_EPE_RTOL and pose_err <= EVAL_POSE_ATOL
          and bool(np.isfinite(rows_g[0]).all()))
    return {"shape": [SMALL_SAMPLES, *SMALL_FRAME], "net": list(SMALL_NET), "thresholds": thresholds,
            "pred_max_abs_err": pred_err, "tol_pred": EVAL_PRED_ATOL,
            "rows_max_abs_err": float(np.nanmax(np.abs(rows_g - rows_c))), "tol_rows": EVAL_ROW_ATOL,
            "epe_cuda": epe_g.tolist(), "epe_cpu": epe_c.tolist(), "epe_rel_err": epe_rel, "tol_epe_rel": EVAL_EPE_RTOL,
            "pose_max_abs_err": pose_err, "tol_pose": EVAL_POSE_ATOL, "ok": ok}


def eval_kernel_segments(smi: str) -> dict:
    """The kernel on one eval batch's maps (B = 8, 192×640): evaluate_mix's
    one and evaluate_flow's two in one launch, against the plain version,
    then timed warm as phase 3 times the step's maps."""
    import torch

    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import eval_maps

    out = {}
    for i, cli in enumerate(("mix", "flow")):
        maps = eval_maps(cli, EVAL_BATCH, HEIGHT, WIDTH, seed=300 + i)
        err = check_maps(E, maps, f"evaluate_{cli}", True)
        dev = maps[0].flow.device
        o = torch.empty(E.out_offsets(maps)[1], device=dev)
        table = E.build_table(maps, o)
        ms = device_ms(lambda: E.launch(table, dev), KERNEL_REPS, KERNEL_WARMUP)
        plain_ms = device_ms(lambda: E.epipolar_abs_residual_maps_reference(maps), KERNEL_REPS, KERNEL_WARMUP)
        bound_ms, bound_by = bound_of(*epi_bound_ms(maps))
        out[f"evaluate_{cli}"] = {"maps_a_launch": len(maps), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound_warm": bound_ms / ms}
    emit({"phase": "kernel_time", "kernel": "epipolar_abs_residual_maps",
          "work": "one eval batch, B=8 at 192x640", "eval": out, "reps": KERNEL_REPS, "card": smi})
    return out


def evaluate_mix_breakdown(cfg, total_s: float) -> dict:
    """Where a warm evaluate_mix call's ``total_s`` goes, on the host clock:
    building and loading the nets, decoding the samples (KittiSegDataset),
    the panels (a call without them, subtracted), and the rest (the batches'
    forward and kernel, the upsampling, the GT reads and the scoring)."""
    import dataclasses

    from mdn_sfm_tpu_torch import evaluate_mix
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.data.eval_datasets import KittiSegDataset

    t0 = time.perf_counter()
    T.load_eval_models(cfg, "cuda")
    nets_s = time.perf_counter() - t0
    data = KittiSegDataset(cfg.data_root, cfg.height, cfg.width, n=cfg.eval_num_samples)
    t0 = time.perf_counter()
    for j in range(len(data)):
        data[j]
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    evaluate_mix.evaluate(dataclasses.replace(cfg, save_pred_masks=False), device="cuda")
    panels_s = total_s - (time.perf_counter() - t0)
    return {"total": total_s, "nets_build_and_load": nets_s, "decode": decode_s, "panels": panels_s,
            "rest": total_s - nets_s - decode_s - panels_s}


def eval_phase(smi: str) -> dict:
    """Phase 7: the four eval CLIs on the card at 640×192, bf16, batch 8, on
    a 16-sample world at KITTI's frame size: each run twice (a warm-up, then
    timed), the epipolar launches and maps of each run counted, every output
    file checked; the kernel on the eval batches' maps; and the f32 CLIs on
    a small world on the card against the CPU."""
    import shutil
    import tempfile

    import numpy as np

    from mdn_sfm_tpu_torch import evaluate_flow, evaluate_mask, evaluate_mix, evaluate_pose
    from mdn_sfm_tpu_torch.ops import epipolar as E

    t_phase = time.perf_counter()
    kern = eval_kernel_segments(smi)
    base = tempfile.mkdtemp(prefix="mdn_eval_")
    try:
        t0 = time.perf_counter()
        cfg = write_eval_world(os.path.join(base, "full"), EVAL_SAMPLES, (KITTI_H, KITTI_W), (HEIGHT, WIDTH))
        world_s = time.perf_counter() - t0
        expected = {"evaluate_mix": (2, 2), "evaluate_flow": (2, 4), "evaluate_mask": (0, 0), "evaluate_pose": (0, 0)}
        clis, results = {}, {}
        for mod in (evaluate_mix, evaluate_mask, evaluate_flow, evaluate_pose):
            name = mod.__name__.rsplit(".", 1)[1]
            counts, secs = [], []
            for _ in range(2):  # a warm-up call, then the timed one
                E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
                t0 = time.perf_counter()
                results[name] = mod.evaluate(cfg, device="cuda")
                secs.append(time.perf_counter() - t0)
                counts.append((E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps))
            # evaluate_pose's samples are snippets of cfg.sequence_length (3) frames
            n = sum(f - 2 for _, f in ODOMETRY) if name == "evaluate_pose" else EVAL_SAMPLES
            clis[name] = {"epipolar_launches": counts[-1][0], "epipolar_maps": counts[-1][1],
                          "expected": list(expected[name]), "counts_ok": all(c == expected[name] for c in counts),
                          "seconds_warmup": secs[0], "seconds": secs[1], "samples": n,
                          "samples_per_s": n / secs[1]}
        breakdown = evaluate_mix_breakdown(cfg, clis["evaluate_mix"]["seconds"])
        files = {k: all(os.path.exists(p) for p in v) for k, v in eval_outputs(cfg).items()}
        finite = {
            "evaluate_mix": bool(np.isfinite(results["evaluate_mix"]).all()),
            "evaluate_flow": bool(np.isfinite(results["evaluate_flow"]).all()),
            "evaluate_pose": bool(all(np.isfinite(x).all() for x in results["evaluate_pose"])),
        }
        small = eval_cuda_vs_cpu(os.path.join(base, "small"))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    ok = all(c["counts_ok"] for c in clis.values()) and all(files.values()) and all(finite.values()) and small["ok"]
    emit({"phase": "eval", "height": HEIGHT, "width": WIDTH, "eval_batch_size": EVAL_BATCH,
          "compute_dtype": "bfloat16", "samples": EVAL_SAMPLES, "frame": [KITTI_H, KITTI_W],
          "world_seconds": world_s, "clis": clis, "evaluate_mix_breakdown_s": breakdown,
          "files_ok": files, "finite": finite,
          "mix_row": results["evaluate_mix"].tolist(), "flow_epe": results["evaluate_flow"].tolist(),
          "pose_ate_re": [x.tolist() for x in results["evaluate_pose"]],
          "cuda_vs_cpu_f32": small, "phase_seconds": time.perf_counter() - t_phase, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the eval phase failed (see its line)")
    return {"clis": clis, "kernel": kern}


def capture_kernel_inputs(fn, *args):
    """Run ``fn(*args)`` with the Mask R-CNN's two kernel entries recorded:
    {"nms": [(boxes, scores, thresh, max_out)], "roi": [(feats, boxes,
    out_size)]}, copies of what the graph hands each call."""
    from mdn_sfm_tpu_torch.masks import maskrcnn as TM

    calls = {"nms": [], "roi": []}
    real_nms, real_roi = TM.nms, TM.multilevel_roi_align

    def nms(boxes, scores, thresh, max_out):
        calls["nms"].append((boxes.clone(), scores.clone(), thresh, max_out))
        return real_nms(boxes, scores, thresh, max_out)

    def roi(feats, boxes, out_size, sampling=2):
        calls["roi"].append(([f.clone() for f in feats[:4]], boxes.clone(), out_size))
        return real_roi(feats, boxes, out_size, sampling)

    TM.nms, TM.multilevel_roi_align = nms, roi
    try:
        fn(*args)
    finally:
        TM.nms, TM.multilevel_roi_align = real_nms, real_roi
    return calls


def nms_bound_ms(boxes, scores, keep, valid) -> tuple[float, str]:
    """The least time of one NMS stage: its inputs read and outputs written
    once, against the IoUs this data needs (each kept box against every box
    after it in score order)."""
    import torch

    n_img, n, _ = boxes.shape
    nbytes = n_img * n * (16 + 4) + keep.numel() * (4 + 1)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=order.device).expand(n_img, n).contiguous())
    ious = int(((n - rank.gather(1, keep.long())) * valid).sum())
    return bound_of(1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * ious * NMS_IOU_FLOP / PEAK_F32_FLOP_PER_S)


def roi_bound_ms(feats, boxes, out_size) -> tuple[float, str]:
    """The least time of one ROIAlign: the feature pixels its taps touch and
    the boxes read once, the output written once, against its blend
    operations."""
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    n_img, n_box, _ = boxes.shape
    c, item = feats[0].shape[-1], feats[0].element_size()
    taps = RA.distinct_taps(boxes, [(f.shape[1], f.shape[2]) for f in feats], out_size)
    outputs = n_img * n_box * out_size * out_size * c
    nbytes = taps * c * item + boxes.numel() * 4 + outputs * item
    return bound_of(1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * outputs * ROI_FLOP_PER_OUTPUT / PEAK_F32_FLOP_PER_S)


def mask_kernel_checks(calls: dict, what: str) -> dict:
    """Each captured NMS call's kernel against its plain version (identical
    keep and valid) and each ROIAlign call's (within ROI_REL_TOL), ROIAlign
    also with the features in the other type."""
    import torch

    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    out = {"nms": [], "roi": []}
    for boxes, scores, thresh, max_out in calls["nms"]:
        kk, vk = N.nms(boxes, scores, thresh, max_out)
        kp, vp = N.nms_reference(boxes, scores, thresh, max_out)
        torch.cuda.synchronize()
        ok = torch.equal(kk, kp) and torch.equal(vk, vp)
        rec = {"shape": list(boxes.shape[:2]), "max_out": max_out, "iou_thresh": thresh,
               "valid_per_image": vp.sum(1).tolist(), "identical": ok,
               "max_abs_err": float((kk.long() - kp.long()).abs().max())}
        emit({"phase": "kernel_check", "kernel": "nms", "inputs": what, **rec})
        if not ok:
            raise AssertionError(f"NMS kernel disagrees with its plain version ({what}, {rec['shape']})")
        out["nms"].append(rec)
    for feats, boxes, out_size in calls["roi"]:
        for dtype in (feats[0].dtype, torch.float32 if feats[0].dtype == torch.bfloat16 else torch.bfloat16):
            fs = [f.to(dtype) for f in feats]
            got = RA.multilevel_roi_align(fs, boxes, out_size)
            want = RA.roi_align_reference(fs, boxes, out_size)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            name = str(dtype).split(".")[1]
            ok = bool(torch.isfinite(got).all()) and err <= ROI_REL_TOL[name] * scale
            rec = {"boxes": list(boxes.shape[:2]), "out_size": out_size, "dtype": name,
                   "levels": [list(f.shape[1:3]) for f in fs], "max_abs_err": err, "max_abs_ref": scale,
                   "tol_rel": ROI_REL_TOL[name], "ok": ok}
            emit({"phase": "kernel_check", "kernel": "roi_align", "inputs": what, **rec})
            if not ok:
                raise AssertionError(f"ROIAlign kernel disagrees with its plain version ({what}, {rec})")
            out["roi"].append(rec)
    return out


def mask_kernel_times(calls: dict, smi: str, what: str) -> dict:
    """Kernel (warm, in a CUDA graph), plain version (event span of a call)
    and bound of each captured call; a step's sums per kernel."""
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    rows = {"nms": [], "roi_align": []}
    for boxes, scores, thresh, max_out in calls["nms"]:
        keep, valid = N.nms(boxes, scores, thresh, max_out)
        bound_ms, bound_by = nms_bound_ms(boxes, scores, keep, valid)
        rows["nms"].append({
            "shape": list(boxes.shape[:2]), "max_out": max_out,
            "ms": device_ms(lambda: N.nms(boxes, scores, thresh, max_out), KERNEL_REPS, KERNEL_WARMUP),
            "plain_ms": call_ms(lambda: N.nms_reference(boxes, scores, thresh, max_out), 5, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
    for feats, boxes, out_size in calls["roi"]:
        bound_ms, bound_by = roi_bound_ms(feats, boxes, out_size)
        rows["roi_align"].append({
            "boxes": list(boxes.shape[:2]), "out_size": out_size, "dtype": str(feats[0].dtype).split(".")[1],
            "ms": device_ms(lambda: RA.multilevel_roi_align(feats, boxes, out_size), KERNEL_REPS, KERNEL_WARMUP),
            "plain_ms": call_ms(lambda: RA.roi_align_reference(feats, boxes, out_size), 5, 1),
            "bound_ms": bound_ms, "bound_by": bound_by})
    for rs in rows.values():
        for r in rs:
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
    emit({"phase": "kernel_time", "inputs": what, **rows, "reps": KERNEL_REPS, "card": smi})
    return rows


def _ds_config(mode: str, thresh: float, log_dir: str, **kw):
    from mdn_sfm_tpu_torch.config import Config, Mode

    base = dict(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode(mode), threshold=9.22,
                compute_dtype="bfloat16", mask_provider="maskrcnn", d2_allow_random_weights=True,
                d2_score_thresh=thresh, d2_infer_scale=2, log_dir=log_dir)
    return Config(**{**base, **kw}).validate()


def ds_step_run(mode: str, thresh: float, log_dir: str, batches: list, smi: str) -> dict:
    """DS_STEPS fused DS or DC steps at 640×192 bs4 bf16 after DS_WARMUP:
    the step times, each kernel's launches in the timed steps (counts set to
    0 just before), the peak memory, the provider's own forward time and the
    union's coverage on the last step's augmented frame."""
    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.data.augment import augment_batch
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    cfg = _ds_config(mode, thresh, log_dir)
    provider = MaskRCNNProvider(cfg, "cuda")
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    for i in range(DS_WARMUP):
        T.train_step(cfg, models, opt, batches[i % 4], generator=T.step_generator(cfg.seed, i, "cuda"),
                     provider=provider)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
    N.nms.launches = RA.multilevel_roi_align.launches = 0
    losses, step_s = [], []
    for i in range(DS_STEPS):
        t0 = time.perf_counter()
        m, _ = T.train_step(cfg, models, opt, batches[i % 4],
                            generator=T.step_generator(cfg.seed, DS_WARMUP + i, "cuda"), provider=provider)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    counts = {"epipolar_launches": E.epipolar_abs_residual_maps.launches,
              "epipolar_maps": E.epipolar_abs_residual_maps.maps,
              "nms_launches": N.nms.launches, "roi_align_launches": RA.multilevel_roi_align.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    _, _, raw0 = augment_batch(cfg, batches[0]["colors_u8"], batches[0]["K"],
                               generator=T.step_generator(cfg.seed, DS_WARMUP, "cuda"))
    images = raw0 * 255.0
    provider_ms = call_ms(lambda: provider.union_fn(images), 10, 2)
    union = provider.union_fn(images)
    med = statistics.median(step_s)
    finite = all(math.isfinite(x) for d in losses for x in d.values())
    expected = {"epipolar_launches": DS_STEPS, "epipolar_maps": 8 * DS_STEPS, "nms_launches": 2 * DS_STEPS,
                "roi_align_launches": 2 * DS_STEPS}
    rec = {"mode": mode, "d2_score_thresh": thresh, "steps": DS_STEPS, "median_step_ms": 1e3 * med,
           "p90_step_ms": 1e3 * sorted(step_s)[int(0.9 * (DS_STEPS - 1))], "min_step_ms": 1e3 * min(step_s),
           "frames_per_s": BATCH / med, "provider_forward_ms": provider_ms,
           "provider_share_of_step": provider_ms / (1e3 * med), **counts, "expected": expected,
           "peak_mem_gib": peak, "union_coverage": float(union.mean()),
           "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"], "losses_finite": finite}
    ok = finite and all(counts[k] == v for k, v in expected.items()) and (thresh > 0.1 or rec["union_coverage"] > 0)
    emit({"phase": "ds_dc_step", **rec, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"the fused {mode} step at d2_score_thresh={thresh} failed (see its line)")
    return {"rec": rec, "provider": provider, "images": images}


def ds_profile(mode: str, thresh: float, log_dir: str, batches: list) -> dict:
    """A device-only torch.profiler trace of 3 fused steps: kernel launches,
    device busy time and idle share a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider
    from mdn_sfm_tpu_torch.profile_step import _device_kernels, _union_us

    cfg = _ds_config(mode, thresh, log_dir)
    provider = MaskRCNNProvider(cfg, "cuda")
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    for i in range(2):
        T.train_step(cfg, models, opt, batches[i], generator=T.step_generator(cfg.seed, i, "cuda"), provider=provider)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            T.train_step(cfg, models, opt, batches[i % 4], generator=T.step_generator(cfg.seed, 2 + i, "cuda"),
                         provider=provider)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kernels = _device_kernels(prof)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / steps
    by_name: dict = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    return {"traced_step_ms": wall_ms, "kernel_launches_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top_kernels": [{"name": n[:90], "calls_per_step": len(d) / steps, "ms_per_step": sum(d) / 1e3 / steps}
                            for n, d in top]}


def precomputed_run(base: str, smi: str) -> dict:
    """The 640×2048 backend (random weights, score 0.05) masks
    BACKEND_FRAMES synthetic target frames through the port's
    precompute_masks, timed; then the DS Trainer trains PRECOMPUTED_STEPS
    steps on those PNGs (no Mask R-CNN in its step)."""
    import numpy as np
    import torch

    from mdn_sfm_tpu_torch.data.synthetic import SyntheticDataset
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNBackend
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.precompute_masks import precompute_masks
    from mdn_sfm_tpu_torch.trainer import Trainer

    data = SyntheticDataset(BACKEND_FRAMES, HEIGHT, WIDTH)
    frames = [data[i][0][0] for i in range(BACKEND_FRAMES)]
    backend = MaskRCNNBackend(max_det=32, score_thresh=0.05, device="cuda")
    calls = capture_kernel_inputs(backend.predict_union_batch, frames[:1])
    mask_dir = os.path.join(base, "masks")
    backend.predict_union_batch(frames[:4])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = precompute_masks(backend, [(str(i), f) for i, f in enumerate(frames)], mask_dir, log_every=0, batch=4)
    backend_s = time.perf_counter() - t0
    coverage = float(np.mean([np.asarray(backend.predict_union(f)).mean() for f in frames[:2]]))

    cfg = _ds_config("DS", 0.05, os.path.join(base, "log"), mask_provider="precomputed", mask_dir=mask_dir,
                     num_epochs=1, limit_train_samples=BATCH * PRECOMPUTED_STEPS, save_frequency=10**6,
                     log_frequency=1, num_workers=2, other_files_path=os.path.join(base, "files"), v_save="vpre")
    E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
    N.nms.launches = 0
    class QuietTrainer(Trainer):
        def _make_writers(self):
            return None

    tr = QuietTrainer(cfg, synthetic=True, device="cuda")
    tr.train()
    losses = [loss for _, _, loss in tr.step_log]
    rec = {"backend_input": list(backend.input_hw), "frames": BACKEND_FRAMES, "precompute": stats,
           "backend_frames_per_s": BACKEND_FRAMES / backend_s, "backend_union_coverage": coverage,
           "trainer_steps": len(losses), "trainer_losses": losses,
           "trainer_median_step_ms": 1e3 * statistics.median(s for _, s, _ in tr.step_log),
           "epipolar_launches": E.epipolar_abs_residual_maps.launches, "nms_launches": N.nms.launches}
    ok = (stats["written"] == BACKEND_FRAMES and len(losses) == PRECOMPUTED_STEPS
          and all(math.isfinite(x) for x in losses) and rec["epipolar_launches"] == PRECOMPUTED_STEPS
          and rec["nms_launches"] == 0)
    emit({"phase": "ds_precomputed", **rec, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the precomputed DS run failed (see its line)")
    return {"rec": rec, "calls": calls}


def ds_cuda_vs_cpu() -> dict:
    """Small f32 DS steps (64×96, batch 2, a fixed instance mask in the
    batch) and a small f32 Mask R-CNN's detections (random weights, score
    0.05) on the card against the CPU."""
    import numpy as np
    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
    from mdn_sfm_tpu_torch.masks import maskrcnn as TM

    small = Config(height=64, width=96, batch_size=2, mode=Mode.DS, threshold=9.22, w_d2_sim=0.05,
                   ds_similarity_term=True, compute_dtype="float32", disable_augment=True).validate()
    colors, K = synthetic_batch(2, 64, 96, seed=0)
    mask = np.zeros((2, 64, 96), np.float32)
    mask[:, 16:40, 24:70] = 1.0
    runs = {}
    for dev in ("cpu", "cuda"):
        nets = T.build_models(small, torch.Generator().manual_seed(0), dev)
        o = T.make_optimizer(small, nets, steps_per_epoch=10)
        b = {"colors_u8": torch.from_numpy(colors).to(dev), "K": torch.from_numpy(K).to(dev),
             "instance_mask": torch.from_numpy(mask).to(dev)}
        runs[dev] = [{k: float(v) for k, v in T.train_step(small, nets, o, b)[0].items()} for _ in range(2)]
    rtols = (1e-5, 3e-5)
    rel = [max(abs(runs["cuda"][s][k] - runs["cpu"][s][k]) / max(abs(runs["cpu"][s][k]), 1e-12)
               for k in runs["cpu"][s]) for s in range(2)]

    img = torch.from_numpy(np.random.default_rng(11).uniform(0, 255, (2, 128, 256, 3)).astype(np.float32)
                           - np.array(TM.PIXEL_MEAN_BGR, np.float32))
    dets = {}
    for dev in ("cpu", "cuda"):
        model = TM.build_model_and_weights(4, None, score_thresh=0.05, dtype=torch.float32, device=dev)
        model.pre_nms_topk, model.post_nms_topk, model.box_candidates = 64, 32, 64
        with torch.no_grad():
            dets[dev] = [t.cpu() for t in model(img.to(dev), 120.0, 250.0)]
    (bc, sc, cc, mc, vc), (bg, sg, cg, mg, vg) = dets["cpu"], dets["cuda"]
    v = vc & vg
    # reported, not asserted: random f32 weights put RPN scores within the
    # two devices' rounding of each other, where a top-k may swap
    det_agree = (torch.equal(vc, vg) and bool(v.any()) and torch.equal(cc[v], cg[v])
                 and float((sc[v] - sg[v]).abs().max()) <= DET_SCORE_ATOL
                 and float((bc[v] - bg[v]).abs().max()) <= DET_BOX_ATOL
                 and float((mc[v] - mg[v]).abs().max()) <= DET_MASK_ATOL)
    ok = rel[0] <= rtols[0] and rel[1] <= rtols[1]
    return {"ds_step_metric_rel_err": rel, "tol_rel": list(rtols), "detections_valid": [int(vc.sum()), int(vg.sum())],
            "detections_agree": det_agree,
            "score_max_abs_err": float((sc[v] - sg[v]).abs().max()) if v.any() else None,
            "box_max_abs_err": float((bc[v] - bg[v]).abs().max()) if v.any() else None,
            "mask_max_abs_err": float((mc[v] - mg[v]).abs().max()) if v.any() else None, "ok": ok}


def ds_dc_phase(smi: str) -> dict:
    """Phase 8: DS and DC at 640×192 bs4 bf16 with the live Mask R-CNN fused
    into the step (384×1280) at both score thresholds, asserting each
    kernel's launches a step; the NMS and ROIAlign kernels against their
    plain versions on the inputs the provider and the backend give them, and
    timed; a device trace of a DS step; a DS run on precomputed masks; the
    card against the CPU at f32."""
    import shutil
    import tempfile

    import torch

    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="mdn_ds_")
    try:
        batches = []
        for seed in range(4):
            colors, K = synthetic_batch(BATCH, HEIGHT, WIDTH, seed=seed)
            batches.append({"colors_u8": torch.from_numpy(colors).cuda(), "K": torch.from_numpy(K).cuda()})
        runs = {}
        for mode in ("DS", "DC"):
            for thresh in D2_THRESHOLDS:
                run = ds_step_run(mode, thresh, os.path.join(base, "log"), batches, smi)
                runs[(mode, thresh)] = run["rec"]
                if (mode, thresh) == ("DS", D2_THRESHOLDS[-1]):
                    # the kernels on the inputs the fused provider gives them
                    # (the low threshold: real detections behind the class-stage NMS)
                    calls = capture_kernel_inputs(run["provider"].union_fn, run["images"])
                    checks = mask_kernel_checks(calls, "provider 384x1280 B=4")
                    times = mask_kernel_times(calls, smi, "provider 384x1280 B=4")
                del run
                calls = None
        profile = ds_profile("DS", D2_THRESHOLDS[0], os.path.join(base, "log"), batches)
        pre = precomputed_run(base, smi)
        backend_checks = mask_kernel_checks(pre["calls"], "backend 640x2048 B=1")
        backend_times = mask_kernel_times({"nms": pre["calls"]["nms"][:1], "roi": []}, smi, "backend 640x2048 B=1")
        small = ds_cuda_vs_cpu()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    ok = small["ok"]
    emit({"phase": "ds_dc", "device_trace_DS_0.3": profile, "cuda_vs_cpu_f32": small,
          "phase_seconds": time.perf_counter() - t_phase, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the DS/DC phase failed (see its line)")
    main_rec = runs[("DS", D2_THRESHOLDS[0])]
    return {"checks": [checks, backend_checks], "times": times, "backend_times": backend_times,
            "launches": {"nms": main_rec["nms_launches"], "roi_align": main_rec["roi_align_launches"]}}


def mask_kernel_entries(ds: dict) -> list[dict]:
    """The kernels line's entries of the two Mask R-CNN kernels: launches in
    phase 8's main run (DS, score 0.3), and a step's time, plain time and
    bound (both stages of each) at the provider's shapes."""
    def worst(kind):
        return max(r["max_abs_err"] for c in ds["checks"] for r in c[kind])

    out = []
    for name, kind, replaces in (("nms", "nms", "mdn_sfm_tpu/masks/maskrcnn.py:212"),
                                 ("roi_align", "roi", "mdn_sfm_tpu/masks/maskrcnn.py:346")):
        rows = ds["times"]["nms" if name == "nms" else "roi_align"]
        out.append({
            "name": name, "route": "cuda", "source": f"mdn_sfm_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": ds["launches"][name], "max_abs_err": worst(kind),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None,
            "work": "one fused DS step's two stages at 384x1280, B=4: " + "; ".join(
                f"{r.get('shape', r.get('boxes'))}->{r.get('max_out', r.get('out_size'))}" for r in rows),
            "note": "replaces an XLA op of the JAX package, not a Pallas kernel; no single PyTorch call computes it"})
    return out


def _options_config(**kw):
    from mdn_sfm_tpu_torch.config import Config, Mode

    return Config(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                  compute_dtype="bfloat16", **kw).validate()


def _snapshot(models) -> dict:
    """Copies of every net's params and buffers, by net."""
    from mdn_sfm_tpu_torch import training as T

    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for n, m in T.modules_by_name(models).items()}


def _changed(models, before: dict, buffers: bool) -> dict:
    """{net: entries changed} over the params (``buffers``: over the BN
    running statistics)."""
    from mdn_sfm_tpu_torch import training as T

    out = {}
    for n, m in T.modules_by_name(models).items():
        names = [k for k, _ in (m.named_buffers() if buffers else m.named_parameters())]
        out[n] = sum(not torch_equal(m.state_dict()[k], before[n][k]) for k in names)
    return out


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def option_run(name: str, opts: dict, batches: list, smi: str) -> dict:
    """OPTION_STEPS steps of one step-option configuration at 640×192 bs4
    bf16 after OPTION_WARMUP: step times, peak memory, the epipolar launches
    and maps in the timed steps (counts set to 0 just before), finite
    losses, and which nets' params and BN statistics moved."""
    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.ops import epipolar as E

    cfg = _options_config(**opts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    before = _snapshot(models)
    for i in range(OPTION_WARMUP):
        T.train_step(cfg, models, opt, batches[i % 4], generator=T.step_generator(cfg.seed, i, "cuda"))
    torch.cuda.synchronize()
    E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
    losses, step_s = [], []
    for i in range(OPTION_STEPS):
        t0 = time.perf_counter()
        m, _ = T.train_step(cfg, models, opt, batches[i % 4],
                            generator=T.step_generator(cfg.seed, OPTION_WARMUP + i, "cuda"))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    launches, nmaps = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps
    params, stats = _changed(models, before, False), _changed(models, before, True)
    med = statistics.median(step_s)
    rec = {"config": name, "options": opts, "steps": OPTION_STEPS, "median_step_ms": 1e3 * med,
           "p90_step_ms": 1e3 * sorted(step_s)[int(0.9 * (OPTION_STEPS - 1))], "min_step_ms": 1e3 * min(step_s),
           "frames_per_s": BATCH / med, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "epipolar_launches": launches, "epipolar_maps": nmaps,
           "params_changed": params, "bn_statistics_changed": stats,
           "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
           "last_grad_norm": losses[-1]["grad_norm"]}
    finite = all(math.isfinite(x) for d in losses for x in d.values())
    if cfg.fine_tune_flow_motion:  # the plain map with autograd, as JAX takes plain XLA
        counts_ok = launches == 0 and nmaps == 0
        moved = all(params[n] for n in ("flownet", "posenet", "mobile_decoder")) and not any(stats.values())
    else:
        counts_ok = launches == OPTION_STEPS and nmaps == 8 * OPTION_STEPS
        moved = (params["mobile_decoder"] and not params["flownet"] and not params["posenet"]
                 and stats["flownet"] and stats["posenet"])
    ok = finite and counts_ok and bool(moved)
    emit({"phase": "step_option", **rec, "losses_finite": finite, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"the {name} step failed (see its line)")
    return rec


def fine_tune_trace(batches: list) -> dict:
    """A device-only torch.profiler trace of TRACE_STEPS fine-tune steps:
    launches, busy ms and idle share a step; and the plain epipolar map
    (the step's 8 maps, forward and backward) timed alone, beside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import step_maps
    from mdn_sfm_tpu_torch.profile_step import _device_kernels, _union_us

    cfg = _options_config(fine_tune_flow_motion=True)
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    for i in range(2):
        T.train_step(cfg, models, opt, batches[i], generator=T.step_generator(cfg.seed, i, "cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(TRACE_STEPS):
            T.train_step(cfg, models, opt, batches[i % 4], generator=T.step_generator(cfg.seed, 2 + i, "cuda"))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / TRACE_STEPS
    kernels = _device_kernels(prof)
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / TRACE_STEPS
    by_name: dict = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    # the plain map as the fine-tune loss runs it: the step's 8 maps from
    # flow that requires grad, forward and backward
    maps = [m._replace(flow=m.flow.detach().requires_grad_()) for m in step_maps("loss", BATCH, HEIGHT, WIDTH, seed=7)]

    def plain_fwd_bwd():
        out = E.epipolar_abs_residual_maps_reference(maps)
        torch.autograd.grad(sum(o.sum() for o in out), [m.flow for m in maps])

    plain_call_ms = call_ms(plain_fwd_bwd, 20, 5)
    with profile(activities=[ProfilerActivity.CUDA]) as pprof:
        for _ in range(TRACE_STEPS):
            plain_fwd_bwd()
        torch.cuda.synchronize()
    pk = _device_kernels(pprof)
    plain_busy = _union_us([(e.time_range.start, e.time_range.end) for e in pk]) / 1e3 / TRACE_STEPS
    return {"traced_step_ms": wall_ms, "kernel_launches_per_step": len(kernels) / TRACE_STEPS,
            "device_busy_ms_per_step": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "plain_epipolar_maps_fwd_bwd_device_ms": plain_busy, "plain_epipolar_maps_fwd_bwd_launches": len(pk) / TRACE_STEPS,
            "plain_epipolar_maps_fwd_bwd_call_ms": plain_call_ms, "plain_epipolar_share_of_busy": plain_busy / busy_ms,
            "top_kernels": [{"name": n[:90], "calls_per_step": len(d) / TRACE_STEPS,
                             "ms_per_step": sum(d) / 1e3 / TRACE_STEPS} for n, d in top]}


def options_cuda_vs_cpu() -> dict:
    """Small f32 steps (64×96, batch 2, 2 steps, no augmentation) with
    fine-tuning and train-mode BN, and the same with accum_steps=2, on the
    card against the CPU: the metrics at OPTION_RTOLS, each term's
    difference and the params' largest difference and share past 2e-5
    (reported)."""
    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    colors, K = synthetic_batch(2, 64, 96, seed=0)
    out = {}
    for name, kw in (("fine_tune_bn_train", {}), ("fine_tune_bn_train_accum2", dict(accum_steps=2))):
        cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                     compute_dtype="float32", disable_augment=True, fine_tune_flow_motion=True,
                     bn_frozen_eval=False, **kw).validate()
        runs = {}
        for dev in ("cpu", "cuda"):
            nets = T.build_models(cfg, torch.Generator().manual_seed(0), dev)
            o = T.make_optimizer(cfg, nets, steps_per_epoch=10)
            b = {"colors_u8": torch.from_numpy(colors).to(dev), "K": torch.from_numpy(K).to(dev)}
            mets = [{k: float(v) for k, v in T.train_step(cfg, nets, o, b)[0].items()} for _ in range(2)]
            runs[dev] = (mets, {f"{n}.{k}": v.detach().cpu() for n, m in T.modules_by_name(nets).items()
                                for k, v in m.state_dict().items()})
        terms = [{k: abs(runs["cuda"][0][s][k] - runs["cpu"][0][s][k]) / max(abs(runs["cpu"][0][s][k]), 1e-12)
                  for k in runs["cpu"][0][s]} for s in range(2)]
        rel = [max(t.values()) for t in terms]
        pdiff = torch.cat([(runs["cuda"][1][k] - v).abs().flatten() for k, v in runs["cpu"][1].items()])
        ok = rel[0] <= OPTION_RTOLS[0] and rel[1] <= OPTION_RTOLS[1]
        out[name] = {"metric_rel_err": rel, "terms_rel_err": terms, "tol_rel": list(OPTION_RTOLS),
                     "param_max_abs_err": float(pdiff.max()),
                     "param_share_over_2e-5": float((pdiff > 2e-5).float().mean()), "ok": ok}
    return out


def skip_step_check(batches: list) -> dict:
    """skip_nonfinite_updates at the main path's width: a step whose
    gradient is NaN (a NaN intrinsic in one sample) leaves params, μ, ν and
    the count bit for bit, and the next finite step applies. The host syncs
    of a default step and of the skipped step, each under
    ``torch.cuda.set_sync_debug_mode("warn")``: the skip must add none; with
    none in either, the skipped step runs again under ``"error"``."""
    import warnings

    import torch

    from mdn_sfm_tpu_torch import training as T

    import traceback

    here = os.path.dirname(os.path.abspath(__file__))

    def syncs(cfg, models, opt, batch, step):
        """The host syncs of one step: each as the innermost port frames that
        led to it."""
        found = []

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                frames = [f for f in traceback.extract_stack() if f.filename.startswith(here)
                          and not f.filename.endswith("chip_smoke.py")]
                found.append(" < ".join(f"{os.path.relpath(f.filename, here)}:{f.lineno}" for f in frames[::-1][:3])
                             or f"{filename}:{lineno}, no frame of the port on the stack")

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                T.train_step(cfg, models, opt, batch, generator=T.step_generator(cfg.seed, step, "cuda"))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return sorted(set(found))

    out = {}
    default_cfg = _options_config()
    models = T.build_models(default_cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(default_cfg, models, steps_per_epoch=1000)
    T.train_step(default_cfg, models, opt, batches[0], generator=T.step_generator(0, 0, "cuda"))
    out["default_step_syncs_first"] = syncs(default_cfg, models, opt, batches[1], 1)
    out["default_step_syncs"] = syncs(default_cfg, models, opt, batches[2], 2)

    cfg = _options_config(skip_nonfinite_updates=True)
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    T.train_step(cfg, models, opt, batches[0], generator=T.step_generator(0, 0, "cuda"))
    torch.cuda.synchronize()
    before = [t.clone() for t in [p.detach() for p in opt.params] + opt.mu + opt.nu]
    bad = {k: v.clone() for k, v in batches[1].items()}
    bad["K"][0, 0, 0] = float("nan")
    out["skip_step_syncs"] = syncs(cfg, models, opt, bad, 1)
    out["added_syncs"] = sorted(set(out["skip_step_syncs"]) - set(out["default_step_syncs"])
                                - set(out["default_step_syncs_first"]))
    if not out["default_step_syncs"] and not out["skip_step_syncs"]:
        torch.cuda.set_sync_debug_mode("error")
        try:
            T.train_step(cfg, models, opt, bad, generator=T.step_generator(0, 2, "cuda"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out["skip_step_under_error_mode"] = True
    torch.cuda.synchronize()
    after = [p.detach() for p in opt.params] + opt.mu + opt.nu
    out["state_unchanged"] = all(torch.equal(a, b) for a, b in zip(before, after))
    skipped = 2 if out.get("skip_step_under_error_mode") else 1
    out["counts_after_skip"] = [opt.count, int(opt.notfinite_count), int(opt.total_notfinite)]
    counts_ok = out["counts_after_skip"] == [1, skipped, skipped]
    T.train_step(cfg, models, opt, batches[2], generator=T.step_generator(0, 3, "cuda"))
    out["count_after_finite_step"] = opt.count
    out["ok"] = (out["state_unchanged"] and counts_ok and opt.count == 2 and int(opt.notfinite_count) == 0
                 and not out["added_syncs"])
    return out


def fine_tune_trainer_run(base: str, smi: str, device: str = "cuda") -> dict:
    """The Trainer with fine_tune_flow_motion at the main path's width: run A,
    4 steps with a checkpoint every 2 (each holding the three nets and Adam
    over all of them); run B resumed with ``resume="auto"`` from A's step-2
    checkpoint, whose loaded nets and Adam state must equal the files bit for
    bit, and which must finish A's 4 steps with finite losses. The drift of
    B's params from A's is reported (the card's atomics make it nonzero)."""
    import dataclasses
    import shutil

    import torch

    from mdn_sfm_tpu_torch import checkpoints as ckpt
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.trainer import Trainer

    class QuietTrainer(Trainer):
        def _make_writers(self):
            return None

    log = os.path.join(base, "log")
    cfg = _options_config(fine_tune_flow_motion=True, num_epochs=1, limit_train_samples=BATCH * 4,
                          save_frequency=2, log_frequency=1, num_workers=2, log_dir=log,
                          other_files_path=os.path.join(base, "files"), v_save="vft")
    tA = QuietTrainer(cfg, synthetic=True, device=device)
    tA.train()
    nets = ("flownet", "posenet", "mobile_decoder")
    layout_ok = all(sorted(os.listdir(ckpt.weights_folder(log, "vft", i))) == sorted(
        [f"{n}.pth" for n in nets] + ["adam.pth", "meta.json"]) for i in range(3))
    shutil.copytree(ckpt.weights_folder(log, "vft", 0), ckpt.weights_folder(log, "vft_b", 0))
    tB = QuietTrainer(dataclasses.replace(cfg, v_save="vft_b", resume="auto"), synthetic=True, device=device)
    folder = ckpt.weights_folder(log, "vft", 0)
    mods = T.modules_by_name(tB.models)
    loaded = all(torch.equal(v.cpu(), torch.load(os.path.join(folder, f"{n}.pth"), weights_only=True)[k])
                 for n in nets for k, v in mods[n].state_dict().items())
    adam = torch.load(os.path.join(folder, "adam.pth"), weights_only=True)
    adam_ok = (tB.opt.count == 2 and len(adam["state"]) == len(tB.opt.params) and all(
        torch.equal(tB.opt.mu[i].cpu(), s["exp_avg"]) and torch.equal(tB.opt.nu[i].cpu(), s["exp_avg_sq"])
        for i, s in adam["state"].items()))
    tB.train()
    a, b = T.modules_by_name(tA.models), T.modules_by_name(tB.models)
    d = torch.cat([(b[n].state_dict()[k] - v).abs().flatten().float()
                   for n in nets for k, v in a[n].state_dict().items()])
    losses = [loss for _, _, loss in tA.step_log + tB.step_log]
    rec = {"steps_A": tA.step, "steps_B": tB.step, "count_B": tB.opt.count, "start_step_B": tB.start_step,
           "layout_ok": layout_ok, "resume_loaded_exact": loaded, "resume_adam_exact": adam_ok,
           "losses": losses, "drift_max_abs": float(d.max()), "drift_mean_abs": float(d.mean()),
           "median_step_ms_A": 1e3 * statistics.median(s for _, s, _ in tA.step_log)}
    ok = (layout_ok and loaded and adam_ok and tB.start_step == 2 and tA.step == tB.step == tB.opt.count == 4
          and all(math.isfinite(x) for x in losses))
    emit({"phase": "fine_tune_trainer", **rec, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the fine-tune Trainer run failed (see its line)")
    return rec


def rehearsal_run(base: str, smi: str) -> dict:
    """synthetic_e2e.run on the card with REHEARSAL_ARGV: phase 1 must cut
    the eval flow EPE under EPE_CUT of its start with no epipolar launch;
    the calibration launches once a batch; each phase-2 row launches once a
    step for 8 maps (the maskrcnn@2 row also 2 NMS and 2 ROIAlign), and
    separates the patch (sep > 0)."""
    from mdn_sfm_tpu_torch import synthetic_e2e

    args = synthetic_e2e.build_parser().parse_args(REHEARSAL_ARGV + ["--log_dir", os.path.join(base, "e2e")])
    record: dict = {}
    t0 = time.perf_counter()
    result = synthetic_e2e.run(args, record)
    seconds = time.perf_counter() - t0
    p1, cal = record["phase1"], record["calibration"]
    checks = {
        "epe_cut": result["epe_trained"] <= EPE_CUT * result["epe_init"],
        "phase1_no_launch": p1["epipolar_launches"] == 0,
        "calibration_one_launch_a_batch": cal["epipolar_launches"] == cal["batches"],
    }
    for tag, rec in record["phase2"].items():
        row = result["modes"][tag]
        live = "@maskrcnn" in tag
        checks[f"{tag}_launches"] = (rec["epipolar_launches"] == rec["steps"] and rec["epipolar_maps"] == 8 * rec["steps"]
                                     and (rec["nms_launches"] == rec["roi_align_launches"] == 2 * rec["steps"]
                                          if live else rec["nms_launches"] == 0))
        checks[f"{tag}_sep"] = row["sep"] > 0
    ok = all(checks.values())
    emit({"phase": "rehearsal", "argv": REHEARSAL_ARGV, "result": result, "record": record, "checks": checks,
          "seconds": seconds, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the rehearsal failed (see its line)")
    return {"record": record, "result": result}


def options_phase(smi: str) -> dict:
    """Phase 9: the step options at 640×192 bs4 bf16, a device trace of the
    fine-tune step, the f32 option steps on the card against the CPU, the
    skipped non-finite step, the fine-tune Trainer (train, save, resume) and
    the short rehearsal."""
    import shutil
    import tempfile

    import torch

    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    t_phase = time.perf_counter()
    batches = []
    for seed in range(4):
        colors, K = synthetic_batch(BATCH, HEIGHT, WIDTH, seed=seed)
        batches.append({"colors_u8": torch.from_numpy(colors).cuda(), "K": torch.from_numpy(K).cuda()})
    runs = {name: option_run(name, opts, batches, smi) for name, opts in OPTION_CONFIGS}
    base = runs["fine_tune"]["peak_mem_gib"]
    saved = {name: base - runs[name]["peak_mem_gib"] for name in ("fine_tune_remat", "fine_tune_accum2")}
    trace = fine_tune_trace(batches)
    small = options_cuda_vs_cpu()
    skip = skip_step_check(batches)
    tmp = tempfile.mkdtemp(prefix="mdn_e2e_")
    try:
        trainer = fine_tune_trainer_run(tmp, smi)
        rehearsal = rehearsal_run(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(v["ok"] for v in small.values()) and skip["ok"]
    ok = ok and runs["fine_tune_accum2"]["peak_mem_gib"] < runs["fine_tune"]["peak_mem_gib"]
    emit({"phase": "step_options", "peak_mem_saved_gib_vs_fine_tune": saved, "device_trace_fine_tune": trace,
          "cuda_vs_cpu_f32": small, "skip_nonfinite": skip, "phase_seconds": time.perf_counter() - t_phase,
          "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the step-options phase failed (see its line)")
    return {"runs": runs, "trainer": trainer, "rehearsal": rehearsal}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
    from mdn_sfm_tpu_torch.ops import _build
    from mdn_sfm_tpu_torch.ops import epipolar as E

    # ---- 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "device": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- 2. build every kernel from the checkout (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "sources": _build.sources(), "libraries": [p.name for p in libs]})

    # ---- 3. the kernel against its plain version, then timing
    kern = kernel_phase(smi)

    # ---- 4. the main path: TG train steps at 640×192, batch 4, bf16
    cfg = Config(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode.TG, threshold=9.22,
                 w_d2_sim=0.0, compute_dtype="bfloat16").validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    batches = []
    for seed in range(4):
        colors, K = synthetic_batch(BATCH, HEIGHT, WIDTH, seed=seed)
        batches.append({"colors_u8": torch.from_numpy(colors).cuda(), "K": torch.from_numpy(K).cuda()})
    for i in range(WARMUP_STEPS):
        T.train_step(cfg, models, opt, batches[i % 4], generator=T.step_generator(cfg.seed, i, "cuda"))
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in models.mobile.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()

    E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m, _ = T.train_step(cfg, models, opt, batches[i % 4],
                            generator=T.step_generator(cfg.seed, WARMUP_STEPS + i, "cuda"))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    launches, nmaps = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps

    finite = all(math.isfinite(x) for d in losses for x in d.values())
    changed = sum(not torch.equal(v, before[k]) for k, v in models.mobile.state_dict().items())
    med = statistics.median(step_s)
    emit({"phase": "train_step", "mode": "TG", "height": HEIGHT, "width": WIDTH, "batch": BATCH,
          "compute_dtype": "bfloat16", "steps": TRAIN_STEPS, "median_step_ms": 1e3 * med,
          "p90_step_ms": 1e3 * sorted(step_s)[int(0.9 * (TRAIN_STEPS - 1))],
          "min_step_ms": 1e3 * min(step_s), "frames_per_s": BATCH / med,
          "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
          "last_grad_norm": losses[-1]["grad_norm"], "losses_finite": finite,
          "mobile_params_changed": f"{changed}/{len(before)}",
          "epipolar_launches": launches, "expected_launches": TRAIN_STEPS,
          "epipolar_maps": nmaps, "expected_maps": 8 * TRAIN_STEPS,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    if not finite:
        raise AssertionError("non-finite loss in the main path")
    if changed == 0:
        raise AssertionError("the mobile decoder's params did not change")
    if launches != TRAIN_STEPS or nmaps != 8 * TRAIN_STEPS:
        raise AssertionError(f"epipolar kernel launched {launches} times for {nmaps} maps, "
                             f"expected {TRAIN_STEPS} for {8 * TRAIN_STEPS}")

    # ---- 5. the step is right: a small f32 step on the card equals the CPU's
    small = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                   compute_dtype="float32", disable_augment=True).validate()
    colors, K = synthetic_batch(2, 64, 96, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        nets = T.build_models(small, torch.Generator().manual_seed(0), dev)
        o = T.make_optimizer(small, nets, steps_per_epoch=10)
        b = {"colors_u8": torch.from_numpy(colors).to(dev), "K": torch.from_numpy(K).to(dev)}
        mets = [{k: float(v) for k, v in T.train_step(small, nets, o, b)[0].items()} for _ in range(2)]
        runs[dev] = (mets, {k: v.detach().cpu() for k, v in nets.mobile.state_dict().items()})
    # f32 on both sides, TF32 off; step 0 from equal params, step 1 after
    # Adam's first ±lr updates (the bounds tests/test_torch_train_step.py uses)
    rtols = (1e-5, 3e-5)
    rel = [max(abs(runs["cuda"][0][s][k] - runs["cpu"][0][s][k]) / max(abs(runs["cpu"][0][s][k]), 1e-12)
               for k in runs["cpu"][0][s]) for s in range(2)]
    pdiff = torch.cat([(runs["cuda"][1][k] - v).abs().flatten() for k, v in runs["cpu"][1].items()])
    p_ok = float(pdiff.max()) <= 2 * small.learning_rate * 2 and float((pdiff > 2e-5).float().mean()) <= 1e-4
    ok = rel[0] <= rtols[0] and rel[1] <= rtols[1] and p_ok
    emit({"phase": "cuda_vs_cpu_f32", "shape": [2, 64, 96], "steps": 2, "metric_rel_err": rel,
          "tol_rel": list(rtols), "param_max_abs_err": float(pdiff.max()),
          "param_share_over_2e-5": float((pdiff > 2e-5).float().mean()), "ok": ok})
    if not ok:
        raise AssertionError("the f32 train step on the card disagrees with the CPU")

    # ---- 6. the Trainer: train, checkpoint, stop, resume, load back
    trainer_phase(smi, 1e3 * med)

    # ---- 7. the eval CLIs at 640×192, bf16, batch 8
    ev = eval_phase(smi)

    # ---- 8. DS and DC with the Mask R-CNN fused into the step
    ds = ds_dc_phase(smi)

    # ---- 9. the step options and the synthetic rehearsal
    opt9 = options_phase(smi)
    rows = opt9["rehearsal"]["record"]["phase2"]

    # ---- summary lines
    emit({"kernels": [{
        "name": "epipolar_abs_residual_maps",
        "route": "cuda",
        "source": "mdn_sfm_tpu_torch/csrc/epipolar.cu",
        "replaces": "mdn_sfm_tpu/ops/pallas_epipolar.py:31",
        "launches": launches,
        "maps": nmaps,
        "max_abs_err": max([kern["max_abs_err"]] + [k["max_abs_err"] for k in ev["kernel"].values()]),
        "ms": kern["ms"],
        "cold_ms": kern["cold_ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
        "wrapper_call_ms": kern["wrapper_call_ms"],
        "eight_launches_ms": kern["eight_launches_ms"],
        "work": "one train step in one launch: 2 reference frames x 4 scales at B=4, 192x640 ... 24x80",
        # the eval CLIs (phase 7): launches and maps of each timed run, and
        # the kernel on one eval batch's maps (B=8, 192x640), warm
        "eval": {name: {"launches": ev["clis"][name]["epipolar_launches"],
                        "maps": ev["clis"][name]["epipolar_maps"],
                        **{k: ev["kernel"][name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}}
                 for name in ("evaluate_mix", "evaluate_flow")},
        # phase 9: launches and maps in each step option's timed steps (the
        # fine-tune steps take the plain map) and in the rehearsal's rows
        "step_options": {name: {"launches": r["epipolar_launches"], "maps": r["epipolar_maps"]}
                         for name, r in opt9["runs"].items()},
        "rehearsal_phase2": {tag: {"launches": r["epipolar_launches"], "maps": r["epipolar_maps"]}
                             for tag, r in rows.items()},
    }] + mask_kernel_entries(ds)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
