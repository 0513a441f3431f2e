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
calibration, phase 2 in TG and in DS on GT masks and on the live Mask R-CNN);
and K steps a dispatch as one replay of a CUDA graph captured over K steps
(TG at K = 4 and 16, the fused DS step and the fine-tune step at K = 4, each
beside its eager figures and with each kernel's launches counted inside the
graph; a small f32 dispatch against eager steps on the card and against the
CPU, with no host sync; the Trainer at steps_per_dispatch = 4 stopped and
resumed); and data parallelism in a process of its own, one rank of an NCCL
group (the f32 step through the group, eager and as a K = 4 graph, against
the step without one; the main path through the group, eager and at K = 4
with each step's all-reduce inside the graph; the Trainer through it,
stopped and resumed); and the port's tools (quantify_d2_scale at its
defaults with each kernel held against its plain version on the street
scenes' inputs, generate_mobile_gt's predict and generate_masks phases with
the crafted detector, bench_precompute, bench_eval at batch 8 and 1,
bench_e2e's Trainer loop on full-resolution PNGs with its steps and launches
counted, bench_loader); and the serving export (export_model --check, the
program loaded and run in a process that imports torch alone against the
live forward), the step's roofline at K = 16 and the batch-scaling study;
and the JAX package's other configurations at full width, eagerly and at
K = 4 steps a dispatch, each with its kernels' launches counted (the pose
net at 34 and 50 layers, the 50-layer one fine-tuned, TG at Config()'s
default 128×416, SN and T, DS with the fused provider at d2_infer_scale 1
and 4 with its NMS and ROIAlign calls held against their plain versions),
the f32 step of pose 50, SN and T on the card against the CPU, the Trainer
at Config()'s defaults stopped and resumed, and the epipolar kernel at the
default shape against its plain version and its bound.

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
# detections of a small f32 Mask R-CNN on the card against the CPU, on valid
# slots: tests/test_maskrcnn.py's JAX-against-torch tolerances
DET_SCORE_ATOL, DET_BOX_ATOL, DET_MASK_ATOL = 5e-4, 0.1, 2e-3

# Phase 9, the step options: each configuration at the main path's width,
# and the rehearsal (tools/synthetic_e2e.py's round-5 world at 64×128, B=4).
# Its phase 1 runs at --lr1 1e-4: at the tool's 3e-4 the photometric loss's
# degenerate optimum (every warp sample out of bounds) takes some seeds and
# some runs of seed 0 on the card, as it does the JAX tool's seeds (PARITY.md
# names a lower --lr1 as the remedy); at 1e-4 seeds 0-19 and five more runs
# of seed 0 trained, with the eval EPE under 0.29 of its start
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
                  "--bright_world", "--obj_shift", "6", "--obj_size", "16", "--lr1", "1e-4"]
EPE_CUT = 0.7           # phase 1 must bring the eval flow EPE under this share of its start

# Phase 10, steps_per_dispatch > 1: K steps a dispatch, one replay of a CUDA
# graph captured over K steps, at the main path's width
DISPATCH_KS = (4, 16)   # TG; 16 is tools/bench_e2e.py's default
DISPATCH_K = 4          # DS with the fused Mask R-CNN, fine-tune, the f32 check, the Trainer
DISPATCH_TIMED = 5      # timed dispatches after one warm dispatch (≥ 5)
EAGER_TRACE_STEPS = 3   # eager steps in each configuration's device trace, beside the graph's
# the f32 dispatch against eager steps on the card: step 0's losses carry no
# atomics and must be equal bit for bit. grad_norm and the later steps must
# sit within NOISE_MARGIN times the largest gap between EAGER_RUNS eager runs
# of the same steps (the reflection pads' backward adds with atomics, and a
# gradient at that noise flips the sign of Adam's update, so the runs fall
# into a few modes, and a few runs may all land in one), or within the f32
# step's 3e-5 relative; the params within NOISE_MARGIN times the eager runs'
# largest gap, or phase 5's rule (2·lr a step, few past 2e-5)
EAGER_RUNS = 4
NOISE_MARGIN = 2.0
F32_RTOL = 3e-5
GRAPH_TRAINER_STEPS = 14  # the Trainer at K = 4: three dispatches and a tail of two single steps
# Phase 11, data parallelism: the step through a process group of one rank
# (NCCL), in a process of its own; its f32 check holds the group's steps to
# phase 10's rule against steps with no group
DP_STEPS = 20           # timed eager group steps at the main path's width (≥ 20)
DP_TRAINER_STEPS = 8    # the Trainer through the group at 64×96: an epoch of this many steps
DP_STOP_AFTER = 3       # its run B stops after this many steps; B2 resumes it
DP_WORKER_TIMEOUT_S = 180
# several ranks against one process on the global batch, step 0: the bound
# of tests/test_torch_train_step.py (f32, summed in another order)
DP_STEP0_RTOL = 1e-5
# Phase 12, the port's tools at their defaults but where said
TOOL_MAX_DET = 32       # quantify_d2_scale's and bench_precompute's max_det
QUANTIFY_SCALES = (1, 2)
QUANTIFY_IMAGES = 6
PARITY_JAX_IOU = {2: 0.56, 1: 0.25}  # PARITY.md: the JAX tool's mean IoUs at max_det 32
TOOL_SCENES = 4         # street scenes through generate_mobile_gt's predict phase
EVAL_BENCH_N = 32
EVAL_BENCH_BATCHES = (8, 1)
E2E_ITEMS = 200         # bench_e2e's default: full-resolution triplets on disk
E2E_WINDOW_S = 20.0     # bench_e2e's timed window (the tool's default is 60 s)
E2E_WORKERS = 4
LOADER_ITEMS = 24
# Phase 13: the serving export at the JAX tool's defaults (640×192, batch 1,
# bf16, random weights from seed 0), loaded in a process that imports torch
# alone and held against the live forward within one bf16 rounding of each
# output's largest value; the roofline of the main path at K = 16 (phase
# 10's TG K); the scaling study at batches 4-32, remat off and on
EXPORT_BF16_REL = 2.0**-8
ROOFLINE_K = 16
SCALING_BS = (4, 8, 16, 32)
SCALING_K = 8           # bench_scaling's default K
SCALING_ROUNDS = 3      # bench_scaling's default rounds
# Phase 14: the JAX package's other configurations at full width, each
# eagerly and at K = CONFIG_K steps a dispatch (phase 10's K): the deeper
# pose encoders (--num_layers 34 and 50, 50 also fine-tuned), Config()'s
# default shape, SN and T, and DS with the fused provider at d2_infer_scale
# 1 and 4 (score 0.05, as phase 10's DS); random weights from seed 0
CONFIG_WARMUP = 2
CONFIG_EAGER_STEPS = 10  # timed eager steps a configuration
CONFIG_K = 4
CONFIG_DISPATCHES = 3    # timed dispatches after a warm one
CONFIG_DS_SCALES = (1, 4)
# the f32 card-vs-CPU check of the configurations whose nets or loss differ
# from the main path's, at phase 5's rule; pose 50's step 1 at 1e-4: one ulp
# of its flow or decoder params moves step 1 by up to about phase 5's 3e-5 on
# the CPU (tests/test_torch_configs_steps.py::test_pose50_step_one_amplifies_one_ulp),
# and the card sums the convolutions in another order than the CPU
CONFIG_F32 = {"pose50": (dict(num_layers=50), (1e-5, 1e-4)), "SN": (dict(mode="SN"), (1e-5, 3e-5)),
              "T": (dict(mode="T"), (1e-5, 3e-5))}
DEFAULT_TRAINER_STEPS = 12  # the Trainer at Config()'s defaults: one epoch of this many steps
DEFAULT_STOP_AFTER = 6
# the port's device kernels a trace counts by name, each with the wrapper
# counter it must match: an NMS call launches its sort, mask and scan once each
TRACED_KERNELS = {"epipolar_abs_residual_maps": "epipolar_launches", "nms_sort": "nms_launches",
                  "nms_mask": "nms_launches", "nms_scan": "nms_launches", "roi_align": "roi_align_launches"}
# the runtime calls that put work on the device, counted in a dispatch's trace
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")

# The kernels' bounds: their bytes and f32 operations by the formulas of
# mdn_sfm_tpu_torch/roofline.py (epipolar_work, nms_work, roi_align_work),
# over the H100 SXM's published HBM3 rate and float32 rate outside the
# tensor cores (its PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S).
# kernel vs plain: the kernel is built with --fmad=false and rounds op by op
# as the plain version does; allow a few ulp of the map's largest value
EPI_REL_TOL = 1e-5


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def synthetic_batches(height: int = HEIGHT, width: int = WIDTH, batch: int = BATCH) -> list:
    """Four synthetic train batches (seeds 0-3) on the card."""
    import torch

    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    out = []
    for seed in range(4):
        colors, K = synthetic_batch(batch, height, width, seed=seed)
        out.append({"colors_u8": torch.from_numpy(colors).cuda(), "K": torch.from_numpy(K).cuda()})
    return out


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


def _times_ms(work: tuple[int, int]) -> tuple[float, float]:
    """(bytes, f32 operations) → their times in ms at the card's peaks."""
    from mdn_sfm_tpu_torch import roofline as RL

    nbytes, flops = work
    return 1e3 * nbytes / RL.PEAK_BYTES_PER_S, 1e3 * flops / RL.PEAK_F32_FLOP_PER_S


def epi_bound_ms(maps) -> tuple[float, float]:
    """(bytes, operations) times in ms for the maps (``roofline.epipolar_work``:
    each flow read once, each map written once and the pose tables, against
    the maps' f32 operations). The least time the card could take is the
    larger of the two."""
    from mdn_sfm_tpu_torch import roofline as RL

    return _times_ms(RL.epipolar_work(maps))


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

    from mdn_sfm_tpu_torch.config import Config
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import epi_inputs, ragged_maps, step_maps

    # 3a. one map a launch (the one-map entry, pixel flow, scale 1) at the
    # main path's shapes, dense NHWC and the permuted NCHW view, and at the
    # maps of Config()'s default shape (128×416 … 16×52)
    default = Config()
    shapes = [(BATCH, HEIGHT >> s, WIDTH >> s) for s in SCALES]
    shapes += [(2 * BATCH, h, w) for _, h, w in shapes] + [(1, 37, 83)]
    shapes += [(default.batch_size, default.height >> s, default.width >> s) for s in SCALES]
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
        worst = max(worst, check_maps(E, step_maps(layout, default.batch_size, default.height, default.width,
                                                   seed=30 + i), f"{layout} {default.height}x{default.width}", vec))
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
    ``data/worlds.py``, and random weights from seed 0 in the reference
    ``.pth`` layout (flow and pose under v0, the mobile decoder under v1);
    returns the eval Config that reads it."""
    import torch

    from mdn_sfm_tpu_torch import checkpoints as ckpt
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config
    from mdn_sfm_tpu_torch.data.worlds import make_gt_masks, make_kitti2015, make_odometry

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
    """The least time of one NMS stage (``roofline.nms_work``: its inputs read
    and outputs written once, against the IoUs this data needs)."""
    from mdn_sfm_tpu_torch import roofline as RL

    return bound_of(*_times_ms(RL.nms_work(boxes, scores, keep, valid)))


def roi_bound_ms(feats, boxes, out_size) -> tuple[float, str]:
    """The least time of one ROIAlign (``roofline.roi_align_work``: the
    feature pixels its taps touch and the boxes read once, the output
    written once, against its blend operations)."""
    from mdn_sfm_tpu_torch import roofline as RL

    return bound_of(*_times_ms(RL.roi_align_work(feats, boxes, out_size)))


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
                   "levels": [list(f.shape[1:3]) for f in fs], "max_abs_err": err, "exact": err == 0.0,
                   "max_abs_ref": scale, "tol_rel": ROI_REL_TOL[name], "ok": ok}
            emit({"phase": "kernel_check", "kernel": "roi_align", "inputs": what, **rec})
            if not ok:
                raise AssertionError(f"ROIAlign kernel disagrees with its plain version ({what}, {rec})")
            out["roi"].append(rec)
    return out


def nms_kernels_us(call, reps: int = 20) -> dict:
    """Device time of each of an NMS call's three kernels, in µs a call
    (torch.profiler over ``reps`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {name: 0.0 for name in TRACED_KERNELS if name.startswith("nms")}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in out:
                if f"{name}_kernel" in e.name:
                    out[name] += e.time_range.elapsed_us() / reps
    return out


def mask_kernel_times(calls: dict, smi: str, what: str) -> dict:
    """Kernel (warm, in a CUDA graph), plain version (event span of a call)
    and bound of each captured call, and each NMS device kernel's share; a
    step's sums per kernel."""
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    rows = {"nms": [], "roi_align": []}
    for boxes, scores, thresh, max_out in calls["nms"]:
        keep, valid = N.nms(boxes, scores, thresh, max_out)
        bound_ms, bound_by = nms_bound_ms(boxes, scores, keep, valid)
        rows["nms"].append({
            "shape": list(boxes.shape[:2]), "max_out": max_out,
            "ms": device_ms(lambda: N.nms(boxes, scores, thresh, max_out), KERNEL_REPS, KERNEL_WARMUP),
            "kernels_us": nms_kernels_us(lambda: N.nms(boxes, scores, thresh, max_out)),
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

    t_phase = time.perf_counter()
    base = tempfile.mkdtemp(prefix="mdn_ds_")
    try:
        batches = synthetic_batches()
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
        backend_times = mask_kernel_times(pre["calls"], smi, "backend 640x2048 B=1")
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
            "launches": {"nms": main_rec["nms_launches"], "roi_align": main_rec["roi_align_launches"]},
            "runs": runs}


def mask_kernel_entries(ds: dict) -> list[dict]:
    """The kernels line's entries of the two Mask R-CNN kernels: launches in
    phase 8's main run (DS, score 0.3), and a step's time, plain time and
    bound (both stages of each) at the provider's shapes; the backend's
    calls apart."""
    def worst(kind):
        return max(r["max_abs_err"] for c in ds["checks"] for r in c[kind])

    def per_call(rows):
        keys = ("shape", "boxes", "max_out", "out_size", "dtype", "ms", "kernels_us", "plain_ms", "bound_ms",
                "bound_by", "share_of_bound")
        return [{k: r[k] for k in keys if k in r} for r in rows]

    out = []
    for name, kind, replaces, design in (
            ("nms", "nms", "mdn_sfm_tpu/masks/maskrcnn.py:212",
             "redesigned: sort, suppression bitmask over (image, row tile, word tile), one-warp scan; "
             "three device kernels a call (nms_sort, nms_mask, nms_scan), one launch counted"),
            ("roi_align", "roi", "mdn_sfm_tpu/masks/maskrcnn.py:346",
             "redesigned: a block per (box, bin rows), tap offsets and weights in shared memory, "
             "16-byte channel vectors")):
        rows = ds["times"][name]
        out.append({
            "name": name, "route": "cuda", "source": f"mdn_sfm_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": ds["launches"][name], "max_abs_err": worst(kind),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None,
            "work": "one fused DS step's two stages at 384x1280, B=4: " + "; ".join(
                f"{r.get('shape', r.get('boxes'))}->{r.get('max_out', r.get('out_size'))}" for r in rows),
            "provider_calls": per_call(rows), "backend_calls": per_call(ds["backend_times"][name]),
            "note": "replaces an XLA op of the JAX package, not a Pallas kernel; no single PyTorch call computes it; "
                    + design})
    return out


def _options_config(**kw):
    from mdn_sfm_tpu_torch.config import Config, Mode

    return Config(**{**dict(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode.TG, threshold=9.22,
                            w_d2_sim=0.0, compute_dtype="bfloat16"), **kw}).validate()


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

    t_phase = time.perf_counter()
    batches = synthetic_batches()
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


def _zero_counts() -> None:
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    E.epipolar_abs_residual_maps.launches = E.epipolar_abs_residual_maps.maps = 0
    N.nms.launches = RA.multilevel_roi_align.launches = 0


def _counts() -> dict:
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    return {"epipolar_launches": E.epipolar_abs_residual_maps.launches,
            "epipolar_maps": E.epipolar_abs_residual_maps.maps,
            "nms_launches": N.nms.launches, "roi_align_launches": RA.multilevel_roi_align.launches}


def device_trace(fn, steps: int) -> dict:
    """A torch.profiler trace (host and device) of ``fn``, which runs
    ``steps`` train steps: its wall clock, the device's busy time and idle
    share, the host's launch calls and the device's kernels a step, and
    how often each of the port's kernels ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdn_sfm_tpu_torch.profile_step import _device_kernels, _union_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = _device_kernels(prof)
    host = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
            and e.name in HOST_LAUNCH_CALLS]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    named = {name: sum(f"{name}_kernel" in e.name for e in kernels) for name in TRACED_KERNELS}
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return {"wall_ms_per_step": wall_ms / steps, "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "host_launch_calls_per_step": len(host) / steps,
            "host_launch_calls": {n: sum(e.name == n for e in host) for n in HOST_LAUNCH_CALLS
                                  if any(e.name == n for e in host)},
            "device_kernels_per_step": len(kernels) / steps, "port_kernels": named,
            "nccl_kernels_per_step": len(nccl) / steps,
            "nccl_device_ms_per_step": sum(e.time_range.end - e.time_range.start for e in nccl) / 1e3 / steps,
            "nccl_kernel_names": sorted({e.name for e in nccl})}


def graph_run(name: str, cfg, k: int, batches: list, smi: str, eager: dict, provider=None, group=None) -> dict:
    """One configuration at K steps a dispatch: an eager trace of
    EAGER_TRACE_STEPS steps, then the capture (timed), one warm dispatch and
    DISPATCH_TIMED timed ones (host clock around each, draws included, ending
    in a sync), the peak memory from before the capture, each kernel's
    launches in those dispatches (counts set to 0 after the capture), and a
    trace of one dispatch, whose kernels must hold each port kernel's
    launches of its K steps. ``eager``: the same configuration's eager
    median and peak from its earlier phase. With a process ``group`` every
    step, eager or captured, takes its all-reduce."""
    import torch

    from mdn_sfm_tpu_torch import training as T

    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    stacked = {key: torch.stack([batches[j % len(batches)][key] for j in range(k)]) for key in batches[0]}
    one = {key: v[0] for key, v in stacked.items()}
    step = [0]

    def eager_steps():
        for _ in range(EAGER_TRACE_STEPS):
            T.train_step(cfg, models, opt, one, generator=T.step_generator(cfg.seed, step[0], "cuda"),
                         provider=provider, group=group)
            step[0] += 1

    eager_steps()  # warm
    eager_trace = device_trace(eager_steps, EAGER_TRACE_STEPS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kstep = T.make_multi_train_step(cfg, models, opt, k, provider=provider, group=group)
    kstep.capture(stacked, T.multi_step_draws(cfg, stacked, step[0], group))

    def dispatch():
        m, _ = kstep(stacked, T.multi_step_draws(cfg, stacked, step[0], group))
        step[0] += k
        return m

    _zero_counts()
    losses = [float(dispatch()["loss"])]
    times = []
    for _ in range(DISPATCH_TIMED):
        t0 = time.perf_counter()
        m = dispatch()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / k)
        losses.append(float(m["loss"]))
    counts = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trace = device_trace(dispatch, k)
    per_step = {"epipolar_launches": 1, "epipolar_maps": 8,
                "nms_launches": 2 if provider is not None else 0,
                "roi_align_launches": 2 if provider is not None else 0}
    if cfg.fine_tune_flow_motion:  # the plain map with autograd: no kernel
        per_step.update(epipolar_launches=0, epipolar_maps=0)
    n_steps = k * (1 + DISPATCH_TIMED)
    expected = {c: n * n_steps for c, n in per_step.items()}
    in_trace = {name: per_step[counter] * k for name, counter in TRACED_KERNELS.items()}
    med = statistics.median(times)
    finite = all(math.isfinite(x) for x in losses)
    rec = {"config": name, "k": k, "capture_s": kstep.capture_seconds,
           "median_ms_per_step": 1e3 * med, "ms_per_step": [1e3 * t for t in times],
           "eager_median_step_ms": eager["median_step_ms"], "speedup_vs_eager": eager["median_step_ms"] / (1e3 * med),
           "peak_mem_gib": peak, "eager_peak_mem_gib": eager["peak_mem_gib"],
           "captured_launches": kstep.captured_launches, **counts, "expected": expected,
           "trace_dispatch": trace, "expected_in_trace": in_trace, "trace_eager": eager_trace,
           "losses": losses, "losses_finite": finite}
    ok = (finite and all(counts[c] == v for c, v in expected.items())
          and trace["port_kernels"] == in_trace and kstep.replays == 2 + DISPATCH_TIMED)
    emit({"phase": "graph_dispatch", **rec, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"the {name} dispatch at K = {k} failed (see its line)")
    del kstep
    return rec


def _gaps(runs: list) -> tuple[dict, float]:
    """The largest gap between any two of ``runs`` of the same steps: per
    metric over its steps, and over the params."""
    metric = {key: max(float((a[0][key] - b[0][key]).abs().max()) for i, a in enumerate(runs) for b in runs[i + 1:])
              for key in runs[0][0]}
    param = max(max(float((x - y).abs().max()) for x, y in zip(a[1], b[1])) for i, a in enumerate(runs)
                for b in runs[i + 1:])
    return metric, param


def _against_eager(got: tuple, runs: list, lr: float, k: int) -> dict:
    """``got`` = ({metric: (K,)}, params) of K steps against ``runs``, the
    same K eager steps from the same state and draws run EAGER_RUNS times:
    step 0's losses bit for bit; every metric within NOISE_MARGIN times the
    runs' largest gap or F32_RTOL relative; the params within NOISE_MARGIN
    times the runs' largest gap or phase 5's rule (2·lr a step, few past
    2e-5)."""
    import torch

    noise, pnoise = _gaps(runs)
    step0_equal = all(torch.equal(got[0][key][0], r[0][key][0]) for r in runs for key in got[0] if key != "grad_norm")
    vs_eager = {key: float((got[0][key] - runs[0][0][key]).abs().max()) for key in got[0]}
    within_noise = {key: vs_eager[key] <= NOISE_MARGIN * noise[key] for key in vs_eager}
    within_rtol = {key: bool(((got[0][key] - runs[0][0][key]).abs() <= F32_RTOL * runs[0][0][key].abs()).all())
                   for key in vs_eager}
    pdiff_all = torch.cat([(x - y).abs().flatten() for x, y in zip(got[1], runs[0][1])])
    pdiff = float(pdiff_all.max())
    p_rule = pdiff <= 2 * lr * k and float((pdiff_all > 2e-5).float().mean()) <= 1e-4
    within = (all(within_noise[key] or within_rtol[key] for key in vs_eager)
              and (pdiff <= NOISE_MARGIN * pnoise or p_rule))
    return {"step0_losses_bitwise_equal": step0_equal, "vs_eager_max_abs": vs_eager, "eager_vs_eager_max_abs": noise,
            "vs_eager_param_max_abs": pdiff, "eager_vs_eager_param_max_abs": pnoise, "eager_runs": len(runs),
            "noise_margin": NOISE_MARGIN, "within_eager_noise": within_noise, "within_f32_rtol": within_rtol,
            "f32_rtol": F32_RTOL, "params_within_phase5_rule": p_rule, "equals_eager": within,
            "ok": step0_equal and within}


def graph_f32_check() -> dict:
    """A K = DISPATCH_K dispatch at the CPU tests' size (64×96, batch 2, f32,
    augmentation on) against K eager steps on the card from the same state
    and the same draws, EAGER_RUNS times, and against the CPU's K steps on
    those draws (phase 5's bounds); then a dispatch replayed under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import numpy as np
    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    k = DISPATCH_K
    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                 compute_dtype="float32").validate()
    pairs = [synthetic_batch(2, 64, 96, seed=s) for s in range(k)]
    host = {"colors_u8": torch.from_numpy(np.stack([c for c, _ in pairs])),
            "K": torch.from_numpy(np.stack([q for _, q in pairs]))}
    cuda = {key: v.cuda() for key, v in host.items()}
    draws = T.multi_step_draws(cfg, cuda, 0)

    def fresh(dev):
        models = T.build_models(cfg, torch.Generator().manual_seed(0), dev)
        return models, T.make_optimizer(cfg, models, steps_per_epoch=10)

    def eager(dev, batches, d):
        models, opt = fresh(dev)
        per = [T.train_step(cfg, models, opt, {key: v[j] for key, v in batches.items()},
                            draws={key: v[j] for key, v in d.items()})[0] for j in range(k)]
        return {key: torch.stack([m[key] for m in per]).cpu() for key in per[0]}, [p.detach().cpu() for p in opt.params]

    runs = [eager("cuda", cuda, draws) for _ in range(EAGER_RUNS)]
    models, opt = fresh("cuda")
    kstep = T.make_multi_train_step(cfg, models, opt, k)
    kstep(cuda, draws)
    graph = ({key: v.cpu() for key, v in kstep.step_metrics.items()}, [p.detach().cpu() for p in opt.params])
    cpu_models, cpu_opt = fresh("cpu")
    cpu_k = T.make_multi_train_step(cfg, cpu_models, cpu_opt, k)
    cpu_k(host, {key: v.cpu() for key, v in draws.items()})
    cpu = ({key: v.clone() for key, v in cpu_k.step_metrics.items()}, [p.detach() for p in cpu_opt.params])

    vs = _against_eager(graph, runs, cfg.learning_rate, k)
    rtols = [1e-5] + [3e-5] * (k - 1)  # phase 5: step 0 from equal params, later steps after Adam's updates
    rel = [max(abs(float(graph[0][key][j]) - float(cpu[0][key][j])) / max(abs(float(cpu[0][key][j])), 1e-12)
               for key in cpu[0]) for j in range(k)]
    cdiff = torch.cat([(x - y).abs().flatten() for x, y in zip(graph[1], cpu[1])])
    cpu_ok = (all(r <= t for r, t in zip(rel, rtols)) and float(cdiff.max()) <= 2 * cfg.learning_rate * k
              and float((cdiff > 2e-5).float().mean()) <= 1e-4)

    # the dispatch's host syncs: none, or the "error" mode raises
    torch.cuda.set_sync_debug_mode("warn")  # the first switch of the mode may sync itself
    torch.cuda.set_sync_debug_mode("error")
    try:
        kstep(cuda, T.multi_step_draws(cfg, cuda, k))
        no_sync = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ok = vs["ok"] and cpu_ok and no_sync and opt.count == 2 * k
    return {"k": k, "shape": [2, 64, 96], "graph_vs_eager": vs,
            "graph_vs_cpu_metric_rel_err": rel, "tol_rel": rtols,
            "graph_vs_cpu_param_max_abs": float(cdiff.max()),
            "graph_vs_cpu_param_share_over_2e-5": float((cdiff > 2e-5).float().mean()), "cpu_ok": cpu_ok,
            "replay_under_sync_error_mode": no_sync, "ok": ok}


def graph_trainer_run(base: str, smi: str) -> dict:
    """The Trainer at steps_per_dispatch = DISPATCH_K (TG, 640×192, bs4,
    bf16): run A, GRAPH_TRAINER_STEPS steps (three dispatches, a tail of two
    single steps) with a checkpoint every 4; run B stopped after its first
    dispatch; run B2 resumed with ``resume="auto"``, whose loaded params and
    Adam equal B's at its stop bit for bit, which takes A's batches, and
    lands within phase 6's bounds of A's params."""
    import torch

    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.trainer import Trainer

    def config(v_save: str, **kw) -> Config:
        return Config(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                      compute_dtype="bfloat16", num_epochs=1, limit_train_samples=BATCH * GRAPH_TRAINER_STEPS,
                      save_frequency=SAVE_EVERY, log_frequency=10**6, num_workers=2,
                      log_dir=os.path.join(base, "log"), other_files_path=os.path.join(base, "files"),
                      v_save=v_save, steps_per_dispatch=DISPATCH_K, **kw).validate()

    _zero_counts()
    t0 = time.perf_counter()
    tA = Trainer(config("vA"), synthetic=True, device="cuda")
    tA.train()
    wall_s = time.perf_counter() - t0
    counts = _counts()
    params_A, _ = _mobile_and_adam(tA)
    tB = Trainer(config("vB"), synthetic=True, device="cuda")
    inner = tB.multi_fn

    def stop_after_dispatch(*a):
        out = inner(*a)
        tB._stop_requested = True  # what the SIGTERM handler sets
        return out

    tB.multi_fn = stop_after_dispatch
    tB.train()
    params_stop, adam_stop = _mobile_and_adam(tB)
    tB2 = Trainer(config("vB", resume="auto"), synthetic=True, device="cuda")
    params_loaded, adam_loaded = _mobile_and_adam(tB2)
    loaded_exact = (_params_equal(params_loaded, params_stop) and _adam_equal(adam_loaded, adam_stop)
                    and tB2.start_step == tB.opt.count == DISPATCH_K)
    tB2.train()
    params_B, _ = _mobile_and_adam(tB2)
    same_batches = tB.sample_history + tB2.sample_history == tA.sample_history
    diff, mean_diff = _drift(params_B, params_A)
    finite = all(bool(torch.isfinite(v).all()) for v in params_A.values())
    # the launches of run A: its steps, and the eager warm-up of its capture
    expected = GRAPH_TRAINER_STEPS + DISPATCH_K
    rec = {"steps_per_dispatch": DISPATCH_K, "steps": GRAPH_TRAINER_STEPS, "capture_s": tA.capture_seconds,
           "run_A_wall_s": wall_s, "steps_logged": [(s, 1e3 * t, loss) for s, t, loss in tA.step_log],
           "epipolar_launches": counts["epipolar_launches"], "expected_launches": expected,
           "resume_start_step": tB2.start_step, "resume_loaded_exact": loaded_exact,
           "resume_same_batches": same_batches, "resume_max_param_abs_diff": diff,
           "resume_param_atol": 2 * LR * (GRAPH_TRAINER_STEPS - DISPATCH_K),
           "resume_mean_param_abs_diff": mean_diff, "resume_mean_atol": RESUME_MEAN_ATOL,
           "adam_count": tA.opt.count, "params_finite": finite}
    ok = (loaded_exact and same_batches and finite and diff <= rec["resume_param_atol"]
          and mean_diff <= RESUME_MEAN_ATOL and tA.opt.count == tB2.opt.count == GRAPH_TRAINER_STEPS
          and counts["epipolar_launches"] == expected)
    emit({"phase": "graph_trainer", **rec, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the Trainer at steps_per_dispatch > 1 failed (see its line)")
    return rec


def dispatch_phase(smi: str, eager: dict) -> dict:
    """Phase 10: K steps a dispatch as one replay of a captured CUDA graph,
    at the main path's width (640×192, batch 4, bf16, random weights from
    seed 0): TG at each K of DISPATCH_KS, DS with the live Mask R-CNN fused
    (384×1280, score 0.05) and the fine-tune step at DISPATCH_K, each beside
    its eager figures; the f32 check on the card; the Trainer's resume.
    ``eager``: {configuration: its eager median and peak from phases 4, 8, 9}."""
    import shutil
    import tempfile

    import torch

    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider

    t_phase = time.perf_counter()
    batches = synthetic_batches()
    runs = {}
    for k in DISPATCH_KS:
        runs[f"TG_K{k}"] = graph_run("TG", _options_config(), k, batches, smi, eager["TG"])
        torch.cuda.empty_cache()
    base = tempfile.mkdtemp(prefix="mdn_graph_")
    try:
        ds_cfg = _ds_config("DS", D2_THRESHOLDS[-1], os.path.join(base, "log"))
        runs["DS_fused"] = graph_run("DS_fused_0.05", ds_cfg, DISPATCH_K, batches, smi, eager["DS"],
                                     provider=MaskRCNNProvider(ds_cfg, "cuda"))
        torch.cuda.empty_cache()
        runs["fine_tune"] = graph_run("fine_tune", _options_config(fine_tune_flow_motion=True), DISPATCH_K,
                                      batches, smi, eager["fine_tune"])
        torch.cuda.empty_cache()
        small = graph_f32_check()
        trainer = graph_trainer_run(base, smi)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit({"phase": "graph_dispatch_summary",
          "ms_per_step": {n: r["median_ms_per_step"] for n, r in runs.items()},
          "eager_ms_per_step": {n: r["eager_median_step_ms"] for n, r in runs.items()},
          "capture_s": {n: r["capture_s"] for n, r in runs.items()},
          "cuda_vs_eager_and_cpu_f32": small, "phase_seconds": time.perf_counter() - t_phase,
          "card": smi, "ok": small["ok"]})
    if not small["ok"]:
        raise AssertionError("the f32 dispatch on the card disagrees with eager steps or the CPU (see its line)")
    return {"runs": runs, "trainer": trainer}


def _rank_rows(batches: dict, rank: int, world: int) -> dict:
    """This rank's rows of (K, B, …) batches or draws."""
    from mdn_sfm_tpu_torch.parallel import local_rows

    return {key: local_rows(v.transpose(0, 1), rank, world).transpose(0, 1).contiguous() for key, v in batches.items()}


def dp_collective_check(group) -> dict:
    """The collective alone: each rank's rank + 1 summed over the group, once
    eagerly and once replayed from a CUDA graph that captured it (after a
    warm-up on a side stream, as ``KStepDispatch`` captures)."""
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    want = world * (world + 1) / 2
    x = torch.full((1024,), float(rank + 1), device="cuda")
    dist.all_reduce(x, group=group)
    eager_ok = bool((x == want).all())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.fill_(rank + 1)
        dist.all_reduce(x, group=group)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        dist.all_reduce(x, group=group)
    x.fill_(rank + 1)
    graph.replay()
    torch.cuda.synchronize()
    graph_ok = bool((x == want).all())
    return {"ranks": world, "eager_ok": eager_ok, "graph_ok": graph_ok, "ok": eager_ok and graph_ok}


def dp_f32_check(group) -> dict:
    """At the CPU tests' size (64×96, 2 samples a rank, f32, augmentation
    on), K = DISPATCH_K steps from one state and one set of draws: the
    group's eager steps against EAGER_RUNS runs of one process with no group
    on the global batch (one rank: phase 10's rule, ``_against_eager``;
    several ranks sum in another order, and Adam's first update flips the
    sign of noise-floor elements, so step 0 alone, within DP_STEP0_RTOL);
    one graph replay of the group's K steps against EAGER_RUNS runs of its
    eager steps (phase 10's rule); every rank's params equal bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    k = DISPATCH_K
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    cfg = Config(height=64, width=96, batch_size=2 * world, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                 compute_dtype="float32").validate()
    pairs = [synthetic_batch(2 * world, 64, 96, seed=s) for s in range(k)]
    batches = {"colors_u8": torch.from_numpy(np.stack([c for c, _ in pairs])).cuda(),
               "K": torch.from_numpy(np.stack([q for _, q in pairs])).cuda()}
    draws = T.multi_step_draws(cfg, batches, 0)
    mine = _rank_rows(batches, rank, world)

    def run(g):
        b, d = (mine, T.multi_step_draws(cfg, mine, 0, g)) if g is not None else (batches, draws)
        models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
        opt = T.make_optimizer(cfg, models, steps_per_epoch=10)
        per = [T.train_step(cfg, models, opt, {key: v[j] for key, v in b.items()},
                            draws={key: v[j] for key, v in d.items()}, group=g)[0] for j in range(k)]
        return {key: torch.stack([m[key] for m in per]).cpu() for key in per[0]}, [p.detach().cpu() for p in opt.params]

    alone = [run(None) for _ in range(EAGER_RUNS)]
    grouped = [run(group) for _ in range(EAGER_RUNS)]
    if world == 1:
        eager = _against_eager(grouped[0], alone, cfg.learning_rate, k)
    else:
        rel = {key: abs(float(grouped[0][0][key][0]) - float(alone[0][0][key][0])) / abs(float(alone[0][0][key][0]))
               for key in alone[0][0]}
        eager = {"step0_rel_err": rel, "tol_rel": DP_STEP0_RTOL, "ok": max(rel.values()) <= DP_STEP0_RTOL}
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=10)
    kstep = T.make_multi_train_step(cfg, models, opt, k, group=group)
    kstep(mine, T.multi_step_draws(cfg, mine, 0, group))
    graph = _against_eager(({key: v.cpu() for key, v in kstep.step_metrics.items()},
                            [p.detach().cpu() for p in opt.params]), grouped, cfg.learning_rate, k)
    flat = torch.cat([p.detach().flatten() for p in opt.params])
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat, group=group)
    ranks_equal = all(torch.equal(x, every[0]) for x in every)
    ok = eager["ok"] and graph["ok"] and ranks_equal and kstep.replays == 1 and opt.count == k
    return {"k": k, "shape": [2 * world, 64, 96], "ranks": world, "group_eager_vs_one_process": eager,
            "group_graph_vs_group_eager": graph, "params_bitwise_equal_across_ranks": ranks_equal, "ok": ok}


def dp_trainer_run(base: str, smi: str) -> dict:
    """The Trainer through the group (TG, 64×96, BATCH a rank, f32; ``base``
    shared by the ranks, rank 0 writes): run
    A, DP_TRAINER_STEPS steps with a checkpoint every SAVE_EVERY; run B
    stopped after DP_STOP_AFTER by the flag the SIGTERM handler sets; run B2
    resumed with ``resume="auto"``, whose loaded params and Adam equal B's
    at its stop bit for bit, which takes A's batches, and lands within phase
    6's bounds of A's params."""
    import torch

    import torch.distributed as dist

    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.parallel import barrier
    from mdn_sfm_tpu_torch.trainer import Trainer

    world = dist.get_world_size()

    def config(v_save: str, **kw) -> Config:
        return Config(height=64, width=96, batch_size=BATCH * world, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                      compute_dtype="float32", num_epochs=1, limit_train_samples=BATCH * world * DP_TRAINER_STEPS,
                      save_frequency=SAVE_EVERY, log_frequency=10**6, num_workers=2,
                      log_dir=os.path.join(base, "log"), other_files_path=os.path.join(base, "files"),
                      v_save=v_save, num_data_shards=world, **kw).validate()

    _zero_counts()
    tA = Trainer(config("vA"), synthetic=True, device="cuda")
    tA.train()
    counts = _counts()
    params_A, _ = _mobile_and_adam(tA)
    tB = Trainer(config("vB"), synthetic=True, device="cuda")
    inner = tB.step_fn

    def stop_after(*a):
        out = inner(*a)
        if len(tB.sample_history) == DP_STOP_AFTER:
            tB._stop_requested = True  # what the SIGTERM handler sets
        return out

    tB.step_fn = stop_after
    tB.train()
    barrier()  # rank 0's checkpoint is on disk before any rank resumes
    params_stop, adam_stop = _mobile_and_adam(tB)
    tB2 = Trainer(config("vB", resume="auto"), synthetic=True, device="cuda")
    params_loaded, adam_loaded = _mobile_and_adam(tB2)
    loaded_exact = (_params_equal(params_loaded, params_stop) and _adam_equal(adam_loaded, adam_stop)
                    and tB2.start_step == tB.opt.count == DP_STOP_AFTER)
    tB2.train()
    params_B, _ = _mobile_and_adam(tB2)
    same_batches = tB.sample_history + tB2.sample_history == tA.sample_history
    diff, mean_diff = _drift(params_B, params_A)
    finite = all(bool(torch.isfinite(v).all()) for v in params_A.values())
    rec = {"group": [tA.rank, tA.world], "steps": DP_TRAINER_STEPS, "shape": [BATCH * world, 64, 96],
           "epipolar_launches": counts["epipolar_launches"], "expected_launches": DP_TRAINER_STEPS,
           "resume_start_step": tB2.start_step, "resume_loaded_exact": loaded_exact,
           "resume_same_batches": same_batches, "resume_max_param_abs_diff": diff,
           "resume_param_atol": 2 * LR * (DP_TRAINER_STEPS - DP_STOP_AFTER),
           "resume_mean_param_abs_diff": mean_diff, "resume_mean_atol": RESUME_MEAN_ATOL,
           "adam_count": tA.opt.count, "params_finite": finite}
    ok = (loaded_exact and same_batches and finite and diff <= rec["resume_param_atol"]
          and mean_diff <= RESUME_MEAN_ATOL and tA.opt.count == tB2.opt.count == DP_TRAINER_STEPS
          and tA.group is not None and counts["epipolar_launches"] == DP_TRAINER_STEPS)
    emit({"phase": "dp_trainer", **rec, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the Trainer through the process group failed (see its line)")
    return rec


def data_parallel_worker(smi: str, base: str) -> None:
    """Phase 11's process: one rank of an NCCL group (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` from
    the parent), the collective alone, the f32 check, the main path through the group (BATCH
    samples a rank: eager steps, then K = DISPATCH_K steps a dispatch as one
    graph with their all-reduces inside), the Trainer through it in
    ``base``. Prints a JSON line a part and its result last."""
    import faulthandler

    import torch
    import torch.distributed as dist

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
    from mdn_sfm_tpu_torch.parallel import init_distributed, local_rows, shutdown_distributed

    # a rank still running near the parent's limit prints where it waits
    faulthandler.dump_traceback_later(DP_WORKER_TIMEOUT_S - 20, exit=False)
    init_distributed("cuda", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), "env://")
    group = dist.group.WORLD
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        coll = dp_collective_check(group)
        emit({"phase": "dp_collective", **coll, "card": smi})
        if not coll["ok"]:
            raise AssertionError("the all-reduce through the group is wrong (see its line)")
        small = dp_f32_check(group)
        emit({"phase": "dp_f32", **small, "card": smi})
        if not small["ok"]:
            raise AssertionError("the f32 step through the group disagrees with the step without (see its line)")

        # the main path through the group: TG, 640×192, BATCH a rank, bf16
        cfg = _options_config(batch_size=BATCH * world)
        models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
        opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
        batches = []
        for seed in range(4):
            colors, K = synthetic_batch(BATCH * world, HEIGHT, WIDTH, seed=seed)
            batches.append({"colors_u8": local_rows(torch.from_numpy(colors), rank, world).cuda(),
                            "K": local_rows(torch.from_numpy(K), rank, world).cuda()})
        for i in range(WARMUP_STEPS):
            T.train_step(cfg, models, opt, batches[i % 4], generator=T.step_generator(cfg.seed, i, "cuda"),
                         group=group)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        times, losses = [], []
        for i in range(DP_STEPS):
            t0 = time.perf_counter()
            m, _ = T.train_step(cfg, models, opt, batches[i % 4],
                                generator=T.step_generator(cfg.seed, WARMUP_STEPS + i, "cuda"), group=group)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        counts = _counts()
        eager = {"median_step_ms": 1e3 * statistics.median(times),
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
        finite = all(math.isfinite(x) for x in losses)
        eager_ok = finite and counts["epipolar_launches"] == DP_STEPS and counts["epipolar_maps"] == 8 * DP_STEPS
        emit({"phase": "dp_train_step", "mode": "TG", "height": HEIGHT, "width": WIDTH, "global_batch": BATCH * world,
              "ranks": world, "rank": rank, "backend": dist.get_backend(), "steps": DP_STEPS, **eager,
              "ms_per_step": [1e3 * t for t in times], **counts, "losses_finite": finite, "card": smi,
              "ok": eager_ok})
        if not eager_ok:
            raise AssertionError("the main path through the group failed (see its line)")
        del models, opt
        torch.cuda.empty_cache()
        graph = graph_run(f"TG_nccl_{world}_rank", cfg, DISPATCH_K, batches, smi, eager, group=group)
        trainer = dp_trainer_run(base, smi)
        nccl_keys = ("nccl_kernels_per_step", "nccl_device_ms_per_step", "nccl_kernel_names")
        emit({"dp_result": {"rank": rank, "ranks": world, "eager": {**eager, **counts},
                            "graph_ms_per_step": graph["median_ms_per_step"], "graph_capture_s": graph["capture_s"],
                            "graph_counts": {c: graph[c] for c in ("epipolar_launches", "epipolar_maps")},
                            "nccl_eager": {key: graph["trace_eager"][key] for key in nccl_keys},
                            "nccl_graph": {key: graph["trace_dispatch"][key] for key in nccl_keys},
                            "trainer_resume_mean_diff": trainer["resume_mean_param_abs_diff"]}})
    finally:
        shutdown_distributed()


def data_parallel_phase(smi: str, tg_eager_ms: float | None, tg_k4_ms: float | None, ranks: int = 1) -> dict:
    """Phase 11: :func:`data_parallel_worker` in ``ranks`` processes of their
    own, one card each, an NCCL group at a free port of 127.0.0.1; rank 0's
    lines pass through, and a summary sets its figures beside phase 4's
    eager step and phase 10's K = DISPATCH_K step of this call (None when
    they did not run)."""
    import shutil
    import socket
    import tempfile

    t_phase = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = tempfile.mkdtemp(prefix="mdn_dp_")
    procs, logs = [], []
    try:
        # each rank writes to files, read after all end: a pipe no one drains
        # could block one rank and, through the collectives, all of them
        for r in range(ranks):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                       WORLD_SIZE=str(ranks), LOCAL_RANK=str(r))
            logs.append(tuple(open(os.path.join(base, f"rank{r}.{ext}"), "w+") for ext in ("out", "err")))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--data-parallel-rank", smi,
                                           base], env=env, stdout=logs[-1][0], stderr=logs[-1][1], text=True))
        deadline = time.monotonic() + DP_WORKER_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                break
        for p in procs:  # a failed or hung rank takes the others down
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
    finally:
        for out, err in logs:
            out.close()
            err.close()
        shutil.rmtree(base, ignore_errors=True)
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = out.strip().splitlines()
        if r == 0:
            for line in lines[:-1]:
                print(line, flush=True)
        if p.returncode != 0 or not lines or "dp_result" not in lines[-1]:
            for q, (o, e) in enumerate(outs):
                print(f"---- rank {q} (exit {procs[q].returncode}) stdout:\n{o[-3000:]}\n---- stderr:\n{e[-6000:]}",
                      file=sys.stderr)
            raise AssertionError(f"the data-parallel phase failed on rank {r} (exit {p.returncode})")
        results.append(json.loads(lines[-1])["dp_result"])
    res = results[0]
    emit({"phase": "data_parallel_summary", "ranks": ranks, "backend": "nccl",
          "eager_ms_per_step": [r["eager"]["median_step_ms"] for r in results],
          "phase4_eager_ms_per_step": tg_eager_ms,
          "k4_ms_per_step": [r["graph_ms_per_step"] for r in results], "phase10_k4_ms_per_step": tg_k4_ms,
          "nccl_eager": res["nccl_eager"], "nccl_graph": res["nccl_graph"],
          "phase_seconds": time.perf_counter() - t_phase, "card": smi, "ok": True})
    return res


def _tree_bytes(root: str) -> dict:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def tool_quantify(smi: str) -> dict:
    """Phase 12 (a): quantify_d2_scale at its defaults (6 scenes of
    375×1242, the providers at scales 1 and 2 for 192×640 training, max_det
    32, the backend at 640×2048), each kernel's launches in it; then the NMS
    and ROIAlign kernels against their plain versions on the inputs scene 0
    gives the scale-1 and scale-2 providers and the backend."""
    from mdn_sfm_tpu_torch import quantify_d2_scale as Q
    from mdn_sfm_tpu_torch.data.worlds import make_street_scene

    backend, providers = Q.build_pipelines(QUANTIFY_SCALES, HEIGHT, WIDTH, TOOL_MAX_DET, device="cuda")
    _zero_counts()
    t0 = time.perf_counter()
    rows, summary = Q.measure(backend, providers, QUANTIFY_IMAGES, HEIGHT, WIDTH)
    seconds = time.perf_counter() - t0
    counts = _counts()
    img = make_street_scene(*Q.SCENE_HW, n_objects=Q.N_OBJECTS, seed=0)[0]
    checks = {"backend 640x2048 B=1 street": mask_kernel_checks(capture_kernel_inputs(backend.predict, img),
                                                                 "backend 640x2048 B=1 street")}
    for s, prov in providers.items():
        what = f"provider@{s} {HEIGHT * s}x{WIDTH * s} B=1 street"
        checks[what] = mask_kernel_checks(capture_kernel_inputs(prov.union_masks_from_images, img[None], HEIGHT,
                                                                WIDTH), what)
    gap = {s: summary[f"mean_iou_scale{s}"] - PARITY_JAX_IOU[s] for s in QUANTIFY_SCALES}
    found = all(r["n_backend"] > 0 for r in rows)
    ordered = summary["mean_iou_scale2"] > summary["mean_iou_scale1"]
    ok = found and ordered and counts["nms_launches"] > 0 and counts["roi_align_launches"] > 0
    emit({"phase": "tool_quantify_d2_scale", "summary": summary, "rows": rows,
          "parity_md_jax_max_det32": PARITY_JAX_IOU, "gap_to_jax": gap, "seconds": seconds, **counts,
          "checks": {what: {"nms_identical": all(r["identical"] for r in c["nms"]),
                            "roi_align_max_abs_err": max(r["max_abs_err"] for r in c["roi"]),
                            "nms_valid_per_image": [r["valid_per_image"] for r in c["nms"]]}
                     for what, c in checks.items()},
          "backend_found_objects_in_every_scene": found, "scale2_above_scale1": ordered, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("quantify_d2_scale failed on the card (see its line)")
    return {"backend": backend, "counts": counts, "checks": checks, "summary": summary}


def tool_generate_mobile_gt(base: str, backend, smi: str) -> dict:
    """Phase 12 (b): generate_mobile_gt's predict phase with the crafted
    backend over TOOL_SCENES street scenes of 375×1242 written as PNGs;
    generate_masks on an instance_numbers.txt that lists every instance of
    each image and one empty line (each GT PNG must equal the union ×255 of
    the masks backend.predict returned for its image, the empty line a 1×1
    zero PNG); --from_semantic_gt on a small instance tree, on the card's
    process and with --device cpu, equal file for file."""
    import numpy as np
    from PIL import Image

    from mdn_sfm_tpu_torch import generate_mobile_gt as G
    from mdn_sfm_tpu_torch.data.worlds import _write_png8, make_kitti2015, make_street_scene

    images = os.path.join(base, "images")
    for i in range(TOOL_SCENES):
        _write_png8(os.path.join(images, f"{i:06d}_10.png"), make_street_scene(375, 1242, seed=100 + i)[0])
    pred, gt_dir = os.path.join(base, "pred"), os.path.join(base, "gt")
    argv = ["--input", images, "--pred_output", pred, "--gt_output", gt_dir, "--n_samples", str(TOOL_SCENES + 1)]
    returned = []
    real_predict = backend.predict

    def predict(img):
        out = real_predict(img)
        returned.append(out[0])
        return out

    backend.predict = predict
    _zero_counts()
    t0 = time.perf_counter()
    try:
        G.predict_with_model(G.get_argparser().parse_args(argv + ["--phase", "predict"]), backend=backend)
    finally:
        backend.predict = real_predict
    predict_s = time.perf_counter() - t0
    counts = _counts()
    os.makedirs(gt_dir, exist_ok=True)
    with open(os.path.join(gt_dir, "instance_numbers.txt"), "w") as f:
        for masks in returned:
            f.write(" ".join(str(i) for i in range(len(masks))) + "\n")
        f.write("\n")
    G.generate_masks(G.get_argparser().parse_args(argv))
    equal = []
    for n in range(TOOL_SCENES + 1):
        with Image.open(os.path.join(gt_dir, f"{n}.png")) as im:
            got = np.asarray(im)
        masks = returned[n] if n < len(returned) else np.zeros((0, 1, 1), np.uint8)
        want = masks.any(0).astype(np.uint8) * 255 if len(masks) else np.zeros((1, 1), np.uint8)
        equal.append(got.shape == want.shape and bool(np.array_equal(got, want)))

    sem = os.path.join(base, "sem")
    make_kitti2015(sem, n=3, h=48, w=96)
    trees = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(base, f"sem_pred_{dev}")
        G.main(["--phase", "predict", "--from_semantic_gt", "--instance_dir",
                os.path.join(sem, "data_semantics", "training", "instance"), "--pred_output", out,
                "--n_samples", "3", "--device", dev])
        trees[dev] = _tree_bytes(out)
    sem_equal = trees["cuda"] == trees["cpu"] and len(trees["cpu"]) == 3
    ok = all(equal) and len(returned) == TOOL_SCENES and sem_equal and counts["nms_launches"] == 2 * TOOL_SCENES
    emit({"phase": "tool_generate_mobile_gt", "scenes": TOOL_SCENES, "instances": [len(m) for m in returned],
          "predict_s": predict_s, **counts, "gt_equals_union_of_predict": equal,
          "from_semantic_gt_files": sorted(trees["cpu"]), "from_semantic_gt_equal_cpu": sem_equal,
          "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("generate_mobile_gt failed on the card (see its line)")
    return {"counts": counts}


def _epoch_counts(trainer_cls, records: list):
    """Trainer.run_epoch wrapped: each call's kernel counts (zeroed just
    before the epoch, read just after its work is done on the card)."""
    import torch

    real = trainer_cls.run_epoch

    def run_epoch(self):
        _zero_counts()
        step0 = self.step
        real(self)
        torch.cuda.synchronize()
        records.append({"steps": self.step - step0, **_counts()})

    return real, run_epoch


def tooling_phase(smi: str, tg_k16_fps: float) -> dict:
    """Phase 12: the port's tools on the card (quantify_d2_scale,
    generate_mobile_gt, bench_precompute, bench_eval, bench_e2e and
    bench_loader), each with its own line, its kernels' launches counted
    around its work."""
    import contextlib
    import io
    import shutil
    import tempfile

    import torch

    from mdn_sfm_tpu_torch import bench_e2e, bench_eval, bench_loader, bench_precompute
    from mdn_sfm_tpu_torch.trainer import Trainer

    t_phase = time.perf_counter()
    quant = tool_quantify(smi)
    base = tempfile.mkdtemp(prefix="mdn_tools_")
    try:
        gen = tool_generate_mobile_gt(base, quant.pop("backend"), smi)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    torch.cuda.empty_cache()

    _zero_counts()
    pre = bench_precompute.main([])
    pre_counts = _counts()
    # one warm-up call and the timed ones of each path, two NMS stages a forward
    pre_ok = pre["n"] == 16 and pre_counts["nms_launches"] == 2 * (1 + pre["n"] + 1 + pre["n"] // pre["batch"])
    emit({"phase": "tool_bench_precompute", "result": pre, **pre_counts, "card": smi, "ok": pre_ok})

    evals = {}
    for b in EVAL_BENCH_BATCHES:
        _zero_counts()
        res = bench_eval.main(["--n", str(EVAL_BENCH_N), "--eval_batch_size", str(b), "--height", str(HEIGHT),
                               "--width", str(WIDTH)])
        c = _counts()
        want = 2 * -(-EVAL_BENCH_N // b)  # a launch a batch, warm-up and timed call
        evals[b] = {"result": res, **c, "ok": c["epipolar_launches"] == want and c["epipolar_maps"] == want}
        emit({"phase": "tool_bench_eval", "eval_batch_size": b, **evals[b], "expected_launches": want, "card": smi})

    records: list = []
    real, wrapped = _epoch_counts(Trainer, records)
    Trainer.run_epoch = wrapped
    try:
        e2e = bench_e2e.main(["--n_items", str(E2E_ITEMS), "--window", str(E2E_WINDOW_S), "--workers",
                              str(E2E_WORKERS), "--batch_size", str(BATCH), "--steps_per_dispatch",
                              str(DISPATCH_KS[-1]), "--height", str(HEIGHT), "--width", str(WIDTH),
                              "--compute_fps", str(tg_k16_fps)])
    finally:
        Trainer.run_epoch = real
    timed = records[1:]  # the first epoch is the warm-up
    per_epoch = E2E_ITEMS // BATCH
    e2e_counts = {k: sum(r[k] for r in timed) for k in ("steps", "epipolar_launches", "epipolar_maps")}
    e2e_ok = (len(timed) == e2e["epochs"] and e2e["steps"] == e2e["epochs"] * per_epoch == e2e_counts["steps"]
              and e2e_counts["epipolar_launches"] == e2e["steps"] and e2e_counts["epipolar_maps"] == 8 * e2e["steps"])
    emit({"phase": "tool_bench_e2e", "result": e2e, "timed_epochs": timed, "warmup_epoch": records[0],
          "timed_counts": e2e_counts, "window_s": E2E_WINDOW_S, "frames_over_compute_only": e2e["value"] / tg_k16_fps,
          "card": smi, "ok": e2e_ok})

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loader = bench_loader.main([str(LOADER_ITEMS)])
    emit({"phase": "tool_bench_loader", "printed": buf.getvalue().splitlines(), "result": loader, "card": smi})

    ok = pre_ok and all(e["ok"] for e in evals.values()) and e2e_ok
    emit({"phase": "tooling", "phase_seconds": time.perf_counter() - t_phase, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("the tooling phase failed (see its lines)")
    return {"quantify": quant, "generate_mobile_gt": gen, "bench_precompute": pre_counts,
            "bench_eval": {b: {k: e[k] for k in ("epipolar_launches", "epipolar_maps")} for b, e in evals.items()},
            "bench_e2e": e2e_counts}


# run in a fresh interpreter that imports torch alone: for each (program,
# saved pair) load the program, run it on the pair with PyTorch's default
# flags and then with utils.use_full_f32's (TF32 off), and hold each run
# against the live outputs
EXPORT_LOAD_AND_RUN = """
import json, sys, time
import torch
args = sys.argv[1:]
defaults = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
records = []
for path, saved in zip(args[::2], args[1::2]):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = defaults
    t0 = time.perf_counter()
    forward = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    d = torch.load(saved)
    errs = {}
    for flags in ("defaults", "full_f32"):
        if flags == "full_f32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            got = forward(d["tgt"], d["ref"])
        errs[flags] = [float((a - b).abs().max()) for a, b in zip(got, d["live"])]
    torch.cuda.synchronize()
    records.append({"load_s": load_s, "max_abs_err": errs, "max_abs": [float(b.abs().max()) for b in d["live"]],
                    "shapes": [list(a.shape) for a in got], "dtypes": [str(a.dtype) for a in got]})
port = sorted(m for m in sys.modules if m.split(".")[0] in ("mdn_sfm_tpu_torch", "mdn_sfm_tpu", "jax"))
assert not port, port
print(json.dumps(records))
"""
# the f32 program of the fresh-process check (a small shape: TF32 shows there)
EXPORT_F32_SHAPE = (2, 64, 96)


def _save_live_pair(path: str, cfg, batch: int) -> None:
    """A random normalized pair and the live forward's outputs on it, with
    the tool's random weights (seed 0), saved at ``path`` for
    :data:`EXPORT_LOAD_AND_RUN`."""
    import numpy as np
    import torch

    from mdn_sfm_tpu_torch import export_model as X
    from mdn_sfm_tpu_torch import training as T

    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.default_rng(1)
    tgt, ref = (torch.from_numpy(rng.normal(size=(batch, cfg.height, cfg.width, 3)).astype(np.float32)).cuda()
                for _ in range(2))
    torch.save({"tgt": tgt, "ref": ref, "live": list(X.build_forward(cfg, models)(tgt, ref))}, path)


def export_check(smi: str) -> dict:
    """(a) ``export_model`` at the JAX tool's defaults on the card with
    ``--check``, the program read back (its convolutions' dtypes, no layout
    copy, no kernel launched); then it and a small f32 program run in a
    fresh process that imports torch alone against the live forward's saved
    outputs: the bf16 one within one bf16 rounding, the f32 one equal with
    TF32 off."""
    import shutil
    import tempfile

    import torch

    from mdn_sfm_tpu_torch import export_model as X
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config

    base = tempfile.mkdtemp(prefix="mdn_export_")
    try:
        out = os.path.join(base, "model.pt2")
        _zero_counts()
        result = X.main(["--out", out, "--log_dir", os.path.join(base, "log"), "--check"])
        counts = _counts()
        program = torch.export.load(out)
        dtypes = X.conv_input_dtypes(program)
        copies = X.copies(program)
        del program
        cfg = Config(height=HEIGHT, width=WIDTH, batch_size=1, compute_dtype="bfloat16").validate()
        _save_live_pair(os.path.join(base, "pair.pt"), cfg, 1)

        b, h, w = EXPORT_F32_SHAPE
        cfg32 = Config(height=h, width=w, batch_size=b, compute_dtype="float32").validate()
        out32 = os.path.join(base, "model_f32.pt2")
        torch.export.save(X.export_model(cfg32, T.build_models(cfg32, torch.Generator().manual_seed(0), "cuda"),
                                         b, "cuda"), out32)
        _save_live_pair(os.path.join(base, "pair_f32.pt"), cfg32, b)

        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", EXPORT_LOAD_AND_RUN, out, os.path.join(base, "pair.pt"), out32,
                              os.path.join(base, "pair_f32.pt")], cwd=base, capture_output=True, text=True,
                             timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
        process_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"the exported programs failed in a fresh process: {res.stderr[-2000:]}")
        fresh, fresh32 = json.loads(res.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(base, ignore_errors=True)
    tol = [EXPORT_BF16_REL * m for m in fresh["max_abs"]]
    want_shapes = [[1, HEIGHT, WIDTH, 2], [1, HEIGHT, WIDTH, 1], [1, 1, 1, 3], [1, 1, 1, 3]]
    ok = (all(e <= t for run in fresh["max_abs_err"].values() for e, t in zip(run, tol))
          and fresh["shapes"] == want_shapes and set(fresh["dtypes"]) == {"torch.float32"}
          and all(math.isfinite(m) for m in fresh["max_abs"])
          and set(dtypes.values()) == {(torch.bfloat16, torch.bfloat16)} and not copies
          and not any(counts.values()) and max(fresh32["max_abs_err"]["full_f32"]) <= X.CHECK_ATOL)
    rec = {"artifact_bytes": result["bytes"], "export_s": result["export_s"],
           "check_in_process": result["check"], "fresh_process_s": process_s, "fresh_process": fresh,
           "fresh_tol_abs": tol,
           "fresh_process_f32": {"shape": list(EXPORT_F32_SHAPE), **fresh32, "tol_abs_full_f32": X.CHECK_ATOL},
           "convolutions": len(dtypes), "conv_input_dtypes": sorted({str(d) for d in dtypes.values()}),
           "layout_copies": copies, "kernel_launches": counts, "card": smi, "ok": ok}
    emit({"phase": "export", **rec})
    if not ok:
        raise AssertionError("the exported program failed its checks (see its line)")
    return rec


def roofline_check(smi: str, tg_k16_ms: float | None) -> dict:
    """(b) ``roofline`` on the main path at K = ROOFLINE_K: its JSON line,
    beside phase 10's TG median at the same K; a compute share outside (0, 1]
    is a counting fault. Its launches: the counted eager step, the capture's
    warm-up of K steps, and K a replay over the warm and timed dispatches."""
    from mdn_sfm_tpu_torch import roofline as RL

    _zero_counts()
    line = RL.main(["--k_steps", str(ROOFLINE_K)])
    counts = _counts()
    steps = 1 + ROOFLINE_K * (2 + RL.TIMED_DISPATCHES)
    expected = {"epipolar_launches": steps, "epipolar_maps": 8 * steps, "nms_launches": 0, "roi_align_launches": 0}
    kernels = line["counted"]["kernels"]
    ok = (0.0 < line["util_compute"] <= 1.0 and counts == expected and kernels["epipolar"]["launches"] == 1
          and kernels["epipolar"]["maps"] == 8 and line["util_bandwidth"] > 0)
    rec = {"roofline": line, "phase10_tg_k16_ms": tg_k16_ms, **counts, "expected": expected,
           "note": ("util_bandwidth above 1: the byte count is the ATen ops' traffic as issued, part of which L2 "
                    "serves" if line["util_bandwidth"] > 1 else None), "card": smi, "ok": ok}
    emit({"phase": "roofline", **rec})
    if not ok:
        raise AssertionError("the roofline failed its checks (see its line)")
    return rec


def scaling_check(smi: str) -> dict:
    """(c) ``bench_scaling`` at SCALING_BS, remat off and on, K =
    SCALING_K: every row a rate or an out-of-memory error, batch 4 without
    remat a rate; on rows that all ran, each made the warm-up's K launches
    and K a replay over 1 + SCALING_ROUNDS dispatches."""
    import contextlib
    import io

    from mdn_sfm_tpu_torch import bench_scaling as BS

    _zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = BS.main(["--bs", ",".join(map(str, SCALING_BS)), "--remat", "off,on", "--k", str(SCALING_K),
                        "--rounds", str(SCALING_ROUNDS)])
    counts = _counts()
    ran = [r for r in rows if "error" not in r]
    steps = len(ran) * SCALING_K * (2 + SCALING_ROUNDS)
    expected = {"epipolar_launches": steps, "epipolar_maps": 8 * steps, "nms_launches": 0, "roi_align_launches": 0}
    first = next(r for r in rows if r["bs"] == SCALING_BS[0] and not r["remat"])
    ok = (all(r.get("frames_per_s", 0) > 0 or r.get("error", "").startswith("OutOfMemoryError") for r in rows)
          and "error" not in first and (len(ran) < len(rows) or counts == expected))
    for r in rows:
        emit({"phase": "scaling_row", **r, "card": smi})
    rec = {"rows": rows, **counts, "expected_if_all_ran": expected, "table": buf.getvalue().splitlines()[-len(rows) - 2:],
           "card": smi, "ok": ok}
    emit({"phase": "scaling", **{k: v for k, v in rec.items() if k != "rows"}})
    if not ok:
        raise AssertionError("the scaling study failed its checks (see its lines)")
    return rec


def export_roofline_phase(smi: str, tg_k16_ms: float | None) -> dict:
    """Phase 13: the serving export, the step's roofline and the scaling
    study on the card (``export_model``, ``roofline``, ``bench_scaling``)."""
    import torch

    t_phase = time.perf_counter()
    export = export_check(smi)
    torch.cuda.empty_cache()
    roof = roofline_check(smi, tg_k16_ms)
    torch.cuda.empty_cache()
    scaling = scaling_check(smi)
    emit({"phase": "export_roofline_scaling", "phase_seconds": time.perf_counter() - t_phase, "card": smi,
          "ok": True})
    return {"export": export, "roofline": roof, "scaling": scaling}


def config_run(name: str, cfg, batches: list, smi: str, provider=None) -> dict:
    """One configuration at full width: CONFIG_EAGER_STEPS eager steps after
    CONFIG_WARMUP (host clock to a sync each), then the same models at
    CONFIG_K steps a dispatch: the capture, one warm dispatch and
    CONFIG_DISPATCHES timed ones (phase 10's per-step time). Each kernel's
    launches are counted from 0 over the eager steps and over the dispatches
    apart, against 1 epipolar launch of 8 maps a step (none when fine-tuning:
    the plain map with autograd) and 2 NMS and 2 ROIAlign launches a fused
    DS step; the losses must be finite; peak memory of each part."""
    import torch

    from mdn_sfm_tpu_torch import training as T

    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    step = 0
    for _ in range(CONFIG_WARMUP):
        T.train_step(cfg, models, opt, batches[step % 4], generator=T.step_generator(cfg.seed, step, "cuda"),
                     provider=provider)
        step += 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_s = [], []
    for _ in range(CONFIG_EAGER_STEPS):
        t0 = time.perf_counter()
        m, _ = T.train_step(cfg, models, opt, batches[step % 4], generator=T.step_generator(cfg.seed, step, "cuda"),
                            provider=provider)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
        step += 1
    eager_counts = _counts()
    eager_peak = torch.cuda.max_memory_allocated() / 2**30

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stacked = {key: torch.stack([batches[j % 4][key] for j in range(CONFIG_K)]) for key in batches[0]}
    kstep = T.make_multi_train_step(cfg, models, opt, CONFIG_K, provider=provider)
    kstep.capture(stacked, T.multi_step_draws(cfg, stacked, step))
    _zero_counts()
    times = []
    for i in range(1 + CONFIG_DISPATCHES):
        t0 = time.perf_counter()
        m, _ = kstep(stacked, T.multi_step_draws(cfg, stacked, step))
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) / CONFIG_K)
        losses.append({k: float(v) for k, v in m.items()})
        step += CONFIG_K
    graph_counts = _counts()
    graph_peak = torch.cuda.max_memory_allocated() / 2**30

    per_step = {"epipolar_launches": 0 if cfg.fine_tune_flow_motion else 1,
                "epipolar_maps": 0 if cfg.fine_tune_flow_motion else 8,
                "nms_launches": 2 if provider is not None else 0,
                "roi_align_launches": 2 if provider is not None else 0}
    n_graph = CONFIG_K * (1 + CONFIG_DISPATCHES)
    finite = all(math.isfinite(x) for d in losses for x in d.values())
    counts_ok = all(eager_counts[c] == n * CONFIG_EAGER_STEPS and graph_counts[c] == n * n_graph
                    for c, n in per_step.items())
    med = statistics.median(step_s)
    rec = {"config": name, "mode": cfg.mode.value, "height": cfg.height, "width": cfg.width,
           "batch": cfg.batch_size, "num_layers": cfg.num_layers, "compute_dtype": cfg.compute_dtype,
           "fine_tune_flow_motion": cfg.fine_tune_flow_motion,
           "d2_infer_scale": cfg.d2_infer_scale if provider is not None else None,
           "eager_steps": CONFIG_EAGER_STEPS, "eager_median_step_ms": 1e3 * med,
           "eager_step_ms": [1e3 * s for s in step_s], "frames_per_s_eager": cfg.batch_size / med,
           "k": CONFIG_K, "capture_s": kstep.capture_seconds,
           "median_ms_per_step": 1e3 * statistics.median(times), "ms_per_step": [1e3 * t for t in times],
           "frames_per_s_graph": cfg.batch_size * 1e3 / (1e3 * statistics.median(times)),
           "losses_finite": finite, "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
           "per_step_expected": per_step, "eager_counts": eager_counts, "graph_counts": graph_counts,
           "graph_steps": n_graph, "peak_mem_gib_eager": eager_peak, "peak_mem_gib_graph": graph_peak,
           "card": smi}
    ok = finite and counts_ok
    emit({"phase": "configuration", **rec, "ok": ok})
    if not ok:
        raise AssertionError(f"configuration {name} failed (see its line)")
    del kstep
    return rec


def configs_cuda_vs_cpu() -> dict:
    """Phase 5's check for the configurations whose nets or loss differ from
    the main path's (CONFIG_F32: the 50-layer pose net, SN, T): 2 f32 steps
    at 64×96, batch 2, no augmentation, on the card against the CPU: the
    metrics within CONFIG_F32's relative bounds (phase 5's 1e-5 and 3e-5 but
    where said), each term's error reported, and the decoder's params within
    2·lr a step with at most a 1e-4 share past 2e-5 (phase 5's rule)."""
    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    colors, K = synthetic_batch(2, 64, 96, seed=0)
    out = {}
    for name, (kw, rtols) in CONFIG_F32.items():
        cfg = Config(**{**dict(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                               compute_dtype="float32", disable_augment=True), **kw}).validate()
        runs = {}
        for dev in ("cpu", "cuda"):
            nets = T.build_models(cfg, torch.Generator().manual_seed(0), dev)
            o = T.make_optimizer(cfg, nets, steps_per_epoch=10)
            b = {"colors_u8": torch.from_numpy(colors).to(dev), "K": torch.from_numpy(K).to(dev)}
            mets = [{k: float(v) for k, v in T.train_step(cfg, nets, o, b)[0].items()} for _ in range(2)]
            runs[dev] = (mets, {k: v.detach().cpu() for k, v in nets.mobile.state_dict().items()})
        terms = [{k: abs(runs["cuda"][0][s][k] - runs["cpu"][0][s][k]) / max(abs(runs["cpu"][0][s][k]), 1e-12)
                  for k in runs["cpu"][0][s]} for s in range(2)]
        rel = [max(t.values()) for t in terms]
        pdiff = torch.cat([(runs["cuda"][1][k] - v).abs().flatten() for k, v in runs["cpu"][1].items()])
        share = float((pdiff > 2e-5).float().mean())
        params_ok = float(pdiff.max()) <= 2 * cfg.learning_rate * 2 and share <= 1e-4
        ok = rel[0] <= rtols[0] and rel[1] <= rtols[1] and params_ok
        out[name] = {"metric_rel_err": rel, "terms_rel_err": terms, "tol_rel": list(rtols),
                     "within_phase5_rule": rel[0] <= 1e-5 and rel[1] <= 3e-5 and params_ok,
                     "param_max_abs_err": float(pdiff.max()), "param_share_over_2e-5": share, "ok": ok}
    return out


def default_trainer_run(smi: str) -> dict:
    """The Trainer at Config()'s defaults (SN, 128×416, batch 4, bf16, a
    ResNet-18 pose net), as ``python -m mdn_sfm_tpu_torch.train
    --synthetic`` runs it, cut to one epoch of DEFAULT_TRAINER_STEPS steps
    with a loss read each step: run A saves once, at its end; run B stops
    after DEFAULT_STOP_AFTER steps (the flag the SIGTERM handler sets: a
    checkpoint at the stop); B2 resumes it with ``resume="auto"``. B2's
    loaded params and Adam state must equal B's at its stop bit for bit, it
    must take A's batches and end within 2·lr a resumed step of A's params,
    nearer them on the mean than a control resumed with Adam's μ and ν
    zeroed."""
    import shutil
    import tempfile

    from mdn_sfm_tpu_torch import checkpoints as ckpt
    from mdn_sfm_tpu_torch.config import Config
    from mdn_sfm_tpu_torch.trainer import Trainer

    with tempfile.TemporaryDirectory(prefix="mdn_default_trainer_") as tmp:
        log_dir = os.path.join(tmp, "log")

        def config(v_save: str, **kw) -> Config:
            return Config(num_epochs=1, limit_train_samples=Config().batch_size * DEFAULT_TRAINER_STEPS,
                          log_frequency=1, log_dir=log_dir, other_files_path=os.path.join(tmp, "files"),
                          v_save=v_save, **kw).validate()

        tA = Trainer(config("vA"), synthetic=True, device="cuda")
        _zero_counts()
        t0 = time.perf_counter()
        tA.train()
        wall_A = time.perf_counter() - t0
        counts = _counts()  # run A's
        saves_A = sorted(os.listdir(os.path.join(log_dir, "vA", "models")))
        params_A, _ = _mobile_and_adam(tA)

        tB = Trainer(config("vB"), synthetic=True, device="cuda")
        inner = tB.step_fn

        def stop_after(batch, generator):
            out = inner(batch, generator)
            if len(tB.sample_history) == DEFAULT_STOP_AFTER:
                tB._stop_requested = True  # what the SIGTERM handler sets
            return out

        tB.step_fn = stop_after
        tB.train()
        params_stop, adam_stop = _mobile_and_adam(tB)
        shutil.copytree(os.path.join(log_dir, "vB", "models"), os.path.join(log_dir, "vC", "models"))
        tB2 = Trainer(config("vB", resume="auto"), synthetic=True, device="cuda")
        params_loaded, adam_loaded = _mobile_and_adam(tB2)
        loaded_exact = (_params_equal(params_loaded, params_stop) and _adam_equal(adam_loaded, adam_stop)
                        and tB2.start_step == tB2.opt.count == DEFAULT_STOP_AFTER)
        tB2.train()
        params_B, _ = _mobile_and_adam(tB2)
        same_batches = tB.sample_history + tB2.sample_history == tA.sample_history
        diff, mean_diff = _drift(params_B, params_A)
        tC = Trainer(config("vC", resume="auto"), synthetic=True, device="cuda")
        for t in tC.opt.mu + tC.opt.nu:
            t.zero_()
        tC.train()
        control_diff, control_mean = _drift(_mobile_and_adam(tC)[0], params_A)
        bound = 2 * tA.cfg.learning_rate * (DEFAULT_TRAINER_STEPS - DEFAULT_STOP_AFTER)
        losses = [loss for _, _, loss in tA.step_log]
        finite = len(losses) == DEFAULT_TRAINER_STEPS and all(math.isfinite(x) for x in losses)
        last = ckpt.weights_folder(log_dir, "vA", ckpt.latest_weights_idx(log_dir, "vA"))
        cfg = tA.cfg
        rec = {"mode": cfg.mode.value, "height": cfg.height, "width": cfg.width, "batch": cfg.batch_size,
               "num_layers": cfg.num_layers, "compute_dtype": cfg.compute_dtype, "steps": DEFAULT_TRAINER_STEPS,
               "run_A_wall_s": wall_A, "median_step_ms": 1e3 * statistics.median(s for _, s, _ in tA.step_log),
               "losses": losses, "losses_finite": finite, "checkpoints_run_A": saves_A,
               "last_checkpoint_step": ckpt.read_meta(last)["step"], **counts,
               "resume_start_step": tB2.start_step, "resume_loaded_exact": loaded_exact,
               "resume_same_batches": same_batches, "resume_max_param_abs_diff": diff,
               "resume_param_bound": bound, "resume_mean_param_abs_diff": mean_diff,
               "control_max_param_abs_diff": control_diff, "control_mean_param_abs_diff": control_mean}
        ok = (finite and [f for f in saves_A if f.startswith("weights_")] == ["weights_0"]
              and rec["last_checkpoint_step"] == DEFAULT_TRAINER_STEPS
              and loaded_exact and same_batches and diff <= bound and mean_diff < control_mean
              and counts["epipolar_launches"] == DEFAULT_TRAINER_STEPS
              and counts["epipolar_maps"] == 8 * DEFAULT_TRAINER_STEPS)
        emit({"phase": "configuration_trainer", **rec, "card": smi, "ok": ok})
        if not ok:
            raise AssertionError("the Trainer at Config()'s defaults failed (see its line)")
    return rec


def default_shape_kernel(smi: str) -> dict:
    """The epipolar kernel on a step's 8 maps at Config()'s default shape
    (128×416 … 16×52, as the loss hands them over) against its plain
    version, then timed as phase 3 times the main path's: one launch warm in
    a CUDA graph, the plain version, and the bound from its bytes and
    operations."""
    import torch

    from mdn_sfm_tpu_torch.config import Config
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import step_maps

    d = Config()
    maps = step_maps("loss", d.batch_size, d.height, d.width, seed=300)
    err = check_maps(E, maps, f"loss {d.height}x{d.width} (phase 14)", True)
    dev = maps[0].flow.device
    out = torch.empty(E.out_offsets(maps)[1], device=dev)
    table = E.build_table(maps, out)
    ms = device_ms(lambda: E.launch(table, dev), KERNEL_REPS, KERNEL_WARMUP)
    plain_ms = device_ms(lambda: E.epipolar_abs_residual_maps_reference(maps), KERNEL_REPS, KERNEL_WARMUP)
    bound_ms, bound_by = bound_of(*epi_bound_ms(maps))
    rec = {"kernel": "epipolar_abs_residual_maps", "shape": [d.batch_size, d.height, d.width],
           "work": "the 8 maps of a train step at Config()'s default shape",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms, "reps": KERNEL_REPS}
    emit({"phase": "kernel_time", **rec, "card": smi})
    return rec


def configurations_phase(smi: str) -> dict:
    """Phase 14: the JAX package's other configurations at full width, one
    line each (``config_run``): the pose net at 34 and 50 layers under TG
    640×192 and the 50-layer one fine-tuned, TG at Config()'s default shape,
    SN and T at 640×192, and DS with the fused provider at d2_infer_scale 1
    (192×640) and 4 (768×2560), whose NMS and ROIAlign calls are held
    against their plain versions and timed; the f32 card-vs-CPU check of
    pose 50, SN and T; the Trainer at Config()'s defaults; the epipolar
    kernel at the default shape."""
    import tempfile

    import torch

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config
    from mdn_sfm_tpu_torch.data.augment import augment_batch
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider

    t_phase = time.perf_counter()
    d = Config()
    batches = synthetic_batches(HEIGHT, WIDTH, BATCH)
    runs, mask = {}, {}
    for name, kw in (("pose34_TG", dict(num_layers=34)), ("pose50_TG", dict(num_layers=50)),
                     ("pose50_fine_tune", dict(num_layers=50, fine_tune_flow_motion=True)),
                     ("SN", dict(mode="SN")), ("T", dict(mode="T"))):
        runs[name] = config_run(name, _options_config(**kw), batches, smi)
        torch.cuda.empty_cache()
    name = f"TG_{d.height}x{d.width}"
    runs[name] = config_run(name, _options_config(height=d.height, width=d.width, batch_size=d.batch_size),
                            synthetic_batches(d.height, d.width, d.batch_size), smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mdn_configs_") as base:
        for scale in CONFIG_DS_SCALES:
            name = f"DS_scale{scale}"
            cfg = _ds_config("DS", D2_THRESHOLDS[-1], os.path.join(base, "log"), d2_infer_scale=scale)
            provider = MaskRCNNProvider(cfg, "cuda")
            runs[name] = config_run(name, cfg, batches, smi, provider=provider)
            # the kernels on the inputs this scale's provider gives them
            _, _, raw = augment_batch(cfg, batches[0]["colors_u8"], batches[0]["K"],
                                      generator=T.step_generator(cfg.seed, 0, "cuda"))
            what = f"provider {HEIGHT * scale}x{WIDTH * scale} B={BATCH} (phase 14)"
            calls = capture_kernel_inputs(provider.union_fn, raw * 255.0)
            mask[name] = {"checks": mask_kernel_checks(calls, what), "times": mask_kernel_times(calls, smi, what)}
            del provider, calls
            torch.cuda.empty_cache()
    small = configs_cuda_vs_cpu()
    trainer = default_trainer_run(smi)
    kernel = default_shape_kernel(smi)
    ok = all(r["ok"] for r in small.values())
    emit({"phase": "configurations", "eager_median_step_ms": {n: r["eager_median_step_ms"] for n, r in runs.items()},
          "ms_per_step_k4": {n: r["median_ms_per_step"] for n, r in runs.items()},
          "peak_mem_gib": {n: max(r["peak_mem_gib_eager"], r["peak_mem_gib_graph"]) for n, r in runs.items()},
          "cuda_vs_cpu_f32": small, "phase_seconds": time.perf_counter() - t_phase, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError("a configuration's f32 step on the card disagrees with the CPU (see its line)")
    return {"runs": runs, "mask": mask, "trainer": trainer, "kernel": kernel}


def data_parallel_only(ranks: int) -> None:
    """``python3 chip_smoke.py --ranks N``: the kernels built and phase 11
    on N cards of this host, N ranks of one NCCL group (each the same checks
    as one rank's; the main path at BATCH samples a rank); the last line as
    the whole script prints it."""
    import torch

    from mdn_sfm_tpu_torch.ops import _build

    if not torch.cuda.is_available() or torch.cuda.device_count() < ranks:
        raise SystemExit(f"chip_smoke --ranks {ranks}: needs {ranks} CUDA devices")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    data_parallel_phase(smi, None, None, ranks)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


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
    batches = synthetic_batches()
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
    tg_peak = torch.cuda.max_memory_allocated() / 2**30
    emit({"phase": "train_step", "mode": "TG", "height": HEIGHT, "width": WIDTH, "batch": BATCH,
          "compute_dtype": "bfloat16", "steps": TRAIN_STEPS, "median_step_ms": 1e3 * med,
          "p90_step_ms": 1e3 * sorted(step_s)[int(0.9 * (TRAIN_STEPS - 1))],
          "min_step_ms": 1e3 * min(step_s), "frames_per_s": BATCH / med,
          "first_loss": losses[0]["loss"], "last_loss": losses[-1]["loss"],
          "last_grad_norm": losses[-1]["grad_norm"], "losses_finite": finite,
          "mobile_params_changed": f"{changed}/{len(before)}",
          "epipolar_launches": launches, "expected_launches": TRAIN_STEPS,
          "epipolar_maps": nmaps, "expected_maps": 8 * TRAIN_STEPS,
          "peak_mem_gib": tg_peak, "card": smi})
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

    # ---- 10. K steps a dispatch as one replay of a captured CUDA graph
    del models, opt
    torch.cuda.empty_cache()
    eager = {"TG": {"median_step_ms": 1e3 * med, "peak_mem_gib": tg_peak},
             "DS": ds["runs"][("DS", D2_THRESHOLDS[-1])], "fine_tune": opt9["runs"]["fine_tune"]}
    graph10 = dispatch_phase(smi, eager)
    graph_counts = {name: {c: r[c] for c in ("epipolar_launches", "epipolar_maps", "nms_launches",
                                             "roi_align_launches")} for name, r in graph10["runs"].items()}
    mask_entries = mask_kernel_entries(ds)
    for entry in mask_entries:
        # phase 10's fused DS dispatches: launches counted as captured launches × replays
        entry["graph_dispatch_launches"] = graph_counts["DS_fused"][f"{entry['name']}_launches"]

    # ---- 11. data parallelism: the step through a one-rank NCCL group
    dp = data_parallel_phase(smi, 1e3 * med, graph10["runs"][f"TG_K{DISPATCH_K}"]["median_ms_per_step"])

    # ---- 12. the tools: quantify_d2_scale, generate_mobile_gt and the bench tools
    tools = tooling_phase(smi, BATCH * 1e3 / graph10["runs"]["TG_K16"]["median_ms_per_step"])
    for entry in mask_entries:
        key = f"{entry['name']}_launches"
        checked = "nms" if entry["name"] == "nms" else "roi"
        new_err = max(r["max_abs_err"] for c in tools["quantify"]["checks"].values() for r in c[checked])
        entry["max_abs_err"] = max(entry["max_abs_err"], new_err)
        # phase 12: launches by tool, and the kernel on the street scenes' inputs
        entry["tooling"] = {"launches": {"quantify_d2_scale": tools["quantify"]["counts"][key],
                                         "generate_mobile_gt": tools["generate_mobile_gt"]["counts"][key],
                                         "bench_precompute": tools["bench_precompute"][key]},
                            "max_abs_err_street_scenes": new_err,
                            "checked_on": sorted(tools["quantify"]["checks"])}

    # ---- 13. the serving export, the step's roofline and the scaling study
    serving = export_roofline_phase(smi, graph10["runs"]["TG_K16"]["median_ms_per_step"])

    # ---- 14. the JAX package's other configurations at full width
    configs = configurations_phase(smi)
    for entry in mask_entries:
        key, checked = f"{entry['name']}_launches", "nms" if entry["name"] == "nms" else "roi"
        new_err = max(r["max_abs_err"] for m in configs["mask"].values() for r in m["checks"][checked])
        entry["max_abs_err"] = max(entry["max_abs_err"], new_err)
        # phase 14: launches in each DS scale's eager steps and dispatches, and
        # each stage's kernel time, plain time and bound on that scale's inputs
        entry["configurations"] = {
            name: {"eager_launches": configs["runs"][name]["eager_counts"][key],
                   "graph_dispatch_launches": configs["runs"][name]["graph_counts"][key],
                   "max_abs_err": max(r["max_abs_err"] for r in m["checks"][checked]),
                   "calls": [{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")}
                             for r in m["times"][entry["name"]]]}
            for name, m in configs["mask"].items()}

    # ---- summary lines
    emit({"kernels": [{
        "name": "epipolar_abs_residual_maps",
        "route": "cuda",
        "source": "mdn_sfm_tpu_torch/csrc/epipolar.cu",
        "replaces": "mdn_sfm_tpu/ops/pallas_epipolar.py:31",
        "launches": launches,
        "maps": nmaps,
        "max_abs_err": max([kern["max_abs_err"], configs["kernel"]["max_abs_err"]]
                           + [k["max_abs_err"] for k in ev["kernel"].values()]),
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
        # phase 10: launches and maps in each configuration's 1 + DISPATCH_TIMED
        # graph dispatches (captured launches × replays; none in the fine-tune step)
        "graph_dispatch": {name: {"launches": c["epipolar_launches"], "maps": c["epipolar_maps"]}
                           for name, c in graph_counts.items()},
        # phase 11: launches and maps in the DP_STEPS eager steps through the
        # one-rank group and in its 1 + DISPATCH_TIMED K-step dispatches
        "data_parallel": {"eager": {"launches": dp["eager"]["epipolar_launches"], "maps": dp["eager"]["epipolar_maps"]},
                          "graph_dispatch": {"launches": dp["graph_counts"]["epipolar_launches"],
                                             "maps": dp["graph_counts"]["epipolar_maps"]}},
        # phase 12: launches and maps in bench_eval's two evaluate_mix calls a
        # batch size and in bench_e2e's timed epochs (captured launches × replays
        # and the tail steps)
        "tooling": {**{f"bench_eval_batch{b}": {"launches": c["epipolar_launches"], "maps": c["epipolar_maps"]}
                       for b, c in tools["bench_eval"].items()},
                    "bench_e2e_timed": {"launches": tools["bench_e2e"]["epipolar_launches"],
                                        "maps": tools["bench_e2e"]["epipolar_maps"],
                                        "steps": tools["bench_e2e"]["steps"]}},
        # phase 13: launches and maps in the roofline's counted step, capture
        # warm-up and dispatches, and in the scaling study's rows (none in the
        # exported forward)
        "roofline_and_scaling": {name: {"launches": serving[name]["epipolar_launches"],
                                        "maps": serving[name]["epipolar_maps"]} for name in ("roofline", "scaling")},
        # phase 14: launches and maps in each configuration's eager steps and
        # K = 4 dispatches (none in the fine-tune steps) and in the Trainer at
        # Config()'s defaults; the kernel on a step's maps at that shape
        "configurations": {**{name: {"eager": {"launches": r["eager_counts"]["epipolar_launches"],
                                               "maps": r["eager_counts"]["epipolar_maps"]},
                                     "graph_dispatch": {"launches": r["graph_counts"]["epipolar_launches"],
                                                        "maps": r["graph_counts"]["epipolar_maps"]}}
                              for name, r in configs["runs"].items()},
                           "trainer_defaults": {"launches": configs["trainer"]["epipolar_launches"],
                                                "maps": configs["trainer"]["epipolar_maps"]}},
        "default_shape": {k: configs["kernel"][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                             "bound_by", "share_of_bound")},
    }] + mask_entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-parallel-rank"]:  # a rank of phase 11
        data_parallel_worker(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--ranks"]:  # phase 11 alone, on that many cards of this host
        data_parallel_only(int(sys.argv[2]))
    else:
        main()
