#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Builds every kernel from ``mdn_sfm_tpu_torch/csrc``, holds each against its
plain PyTorch version at the shapes the main path gives it, drives the main
path — the TG training step at 640×192, batch 4, bf16, ResNet18 flow/pose
nets with random weights from a seed — through ``training.train_step``, and
checks a small f32 step on the card against the same step on the CPU.

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


def epi_inputs(b: int, h: int, w: int, seed: int, nchw_view: bool):
    """Random flow of a few pixels and a KITTI-like forward-moving pose."""
    import torch

    from mdn_sfm_tpu_torch.data.synthetic import synthetic_intrinsics
    from mdn_sfm_tpu_torch.geometry import invert_intrinsics, rot_from_axisangle

    g = torch.Generator().manual_seed(seed)
    if nchw_view:  # the networks' layout, read through a (B, H, W, 2) view
        flow = (3.0 * torch.randn(b, 2, h, w, generator=g)).cuda().permute(0, 2, 3, 1)
    else:
        flow = (3.0 * torch.randn(b, h, w, 2, generator=g)).cuda()
    K = torch.from_numpy(synthetic_intrinsics(h, w)).expand(b, 4, 4)
    inv_K = invert_intrinsics(K).cuda()
    R = rot_from_axisangle(0.01 * torch.randn(b, 3, generator=g)).cuda()
    t = (torch.tensor([0.0, 0.0, 0.8]) + 0.05 * torch.randn(b, 3, generator=g)).cuda()
    return flow, inv_K, R, t


def epi_bound_ms(b: int, h: int, w: int) -> tuple[float, float]:
    """(bytes, operations) times in ms for the map: the flow read once, the
    map written once and the pose tables, against its f32 operations. The
    least time the card could take is the larger of the two."""
    px = b * h * w
    nbytes = px * (2 * 4 + 4) + b * (9 + 9 + 3) * 4
    return 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * px * EPI_FLOP_PER_PX / PEAK_F32_FLOP_PER_S


def bound_of(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")

    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
    from mdn_sfm_tpu_torch.geometry import fundamental_matrix
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

    # ---- 3. kernel vs plain at the main path's shapes, then timing. The main
    # path hands the kernel dense NHWC flow (the loss's scaling to pixels
    # writes it); the permuted NCHW view is the other layout it reads.
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

    # the kernel alone (bare launches, F prebuilt) and the plain version, both
    # as device time on the main path's layout; and the wrapper's span per
    # call as the main path pays it
    per_scale = []
    for i, (b, h, w) in enumerate(shapes[: len(SCALES)]):
        flow, inv_K, R, t = epi_inputs(b, h, w, seed=100 + i, nchw_view=False)
        F = fundamental_matrix(inv_K[..., :3, :3], R, t).reshape(b, 9).contiguous()
        out = torch.empty((b, h, w), device="cuda")
        ms = device_ms(lambda: E.launch(F, flow, out), KERNEL_REPS, KERNEL_WARMUP)
        plain = device_ms(lambda: E.epipolar_abs_residual_reference(flow, inv_K, R, t),
                          KERNEL_REPS, KERNEL_WARMUP)
        call = call_ms(lambda: E.epipolar_abs_residual(flow, inv_K, R, t), KERNEL_REPS, KERNEL_WARMUP)
        t_bytes, t_ops = epi_bound_ms(b, h, w)
        bound, by = bound_of(t_bytes, t_ops)
        per_scale.append((ms, plain, t_bytes, t_ops, call))
        emit({"phase": "kernel_time", "kernel": "epipolar_abs_residual", "shape": [b, h, w],
              "ms": ms, "plain_ms": plain, "wrapper_call_ms": call, "bound_ms": bound,
              "bound_by": by, "share_of_bound": bound / ms, "reps": KERNEL_REPS, "card": smi})
    nref = 2  # reference frames per step
    step_kernel_ms = nref * sum(p[0] for p in per_scale)
    step_plain_ms = nref * sum(p[1] for p in per_scale)
    step_call_ms = nref * sum(p[4] for p in per_scale)
    step_bound_ms, step_bound_by = bound_of(nref * sum(p[2] for p in per_scale),
                                           nref * sum(p[3] for p in per_scale))

    # ---- 4. the main path: TG train steps at 640×192, batch 4, bf16
    cfg = Config(height=HEIGHT, width=WIDTH, batch_size=BATCH, mode=Mode.TG, threshold=9.22,
                 w_d2_sim=0.0, compute_dtype="bfloat16").validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cuda")
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    aug = torch.Generator(device="cuda").manual_seed(1)
    batches = []
    for seed in range(4):
        colors, K = synthetic_batch(BATCH, HEIGHT, WIDTH, seed=seed)
        batches.append({"colors_u8": torch.from_numpy(colors).cuda(), "K": torch.from_numpy(K).cuda()})
    for i in range(WARMUP_STEPS):
        T.train_step(cfg, models, opt, batches[i % 4], generator=aug)
    torch.cuda.synchronize()
    before = {k: v.detach().clone() for k, v in models.mobile.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()

    E.epipolar_abs_residual.launches = 0
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = T.train_step(cfg, models, opt, batches[i % 4], generator=aug)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in m.items()})
    launches = E.epipolar_abs_residual.launches

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
          "epipolar_launches": launches, "expected_launches": 8 * TRAIN_STEPS,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})
    if not finite:
        raise AssertionError("non-finite loss in the main path")
    if changed == 0:
        raise AssertionError("the mobile decoder's params did not change")
    if launches != 8 * TRAIN_STEPS:
        raise AssertionError(f"epipolar kernel launched {launches} times, expected {8 * TRAIN_STEPS}")

    # ---- 5. the step is right: a small f32 step on the card equals the CPU's
    small = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                   compute_dtype="float32", disable_augment=True).validate()
    colors, K = synthetic_batch(2, 64, 96, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        nets = T.build_models(small, torch.Generator().manual_seed(0), dev)
        o = T.make_optimizer(small, nets, steps_per_epoch=10)
        b = {"colors_u8": torch.from_numpy(colors).to(dev), "K": torch.from_numpy(K).to(dev)}
        mets = [{k: float(v) for k, v in T.train_step(small, nets, o, b).items()} for _ in range(2)]
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

    # ---- summary lines
    emit({"kernels": [{
        "name": "epipolar_abs_residual",
        "route": "cuda",
        "source": "mdn_sfm_tpu_torch/csrc/epipolar.cu",
        "replaces": "mdn_sfm_tpu/ops/pallas_epipolar.py:31",
        "launches": launches,
        "max_abs_err": worst,
        "ms": step_kernel_ms,
        "plain_ms": step_plain_ms,
        "bound_ms": step_bound_ms,
        "bound_by": step_bound_by,
        "library_ms": None,
        "wrapper_call_ms": step_call_ms,
        "work": "one train step: 2 reference frames x 4 scales at B=4, 192x640 ... 24x80",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
