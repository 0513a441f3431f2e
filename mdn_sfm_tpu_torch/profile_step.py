"""Where the main path's train step spends its time, on the card.

    python -m mdn_sfm_tpu_torch.profile_step [--steps 10] [--trace DIR] [--mode DS|DC]
        [--fine_tune_flow_motion] [--remat] [--accum_steps 2] [--bn_frozen_eval false]
        [--skip_nonfinite_updates] [--steps_per_dispatch K]

Runs the TG step at 640×192, batch 4, bf16 (random weights from a seed)
through ``training.train_step`` in windows of ``--steps`` steps each. With
``--mode DS`` or ``DC`` the step runs the live Mask R-CNN provider fused
into it (random weights, ``d2_infer_scale`` 2: 384×1280,
``--d2_score_thresh``). The step options take the train flags' names. With
``--steps_per_dispatch`` K > 1 the steps run as dispatches of K steps, each
one replay of a CUDA graph captured over K steps
(``training.make_multi_train_step``), and every window below is one
dispatch: a trace holds one replayed dispatch.

1. a window with no profiler, then ``--rounds`` times a device-only trace
   (``ProfilerActivity.CUDA``: no host ops recorded) followed by another
   window with no profiler. Each trace gives the step's wall time in it, the
   device's busy time (the union of its kernel intervals) and idle share,
   both from that one trace, and the launches a step; the first trace also
   the kernels with the most device time. The windows with no profiler on
   both sides of each trace show what the trace costs;
2. a host and device trace: the host time of each stage of the step
   (``training.STAGES``), which the host trace inflates.

Prints one JSON line. ``--trace DIR`` also writes the host and device
trace there. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import training as T
from .config import Config, Mode
from .data.synthetic import synthetic_batch
from .utils import resolve_device


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _device_kernels(prof) -> list:
    # record_function also puts each stage on the device timeline as a user
    # annotation spanning its kernels, and ProcessGroupNCCL each collective
    # ("nccl:all_reduce", spanning the wait for the other ranks): those are
    # labels, not kernels
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in T.STAGES
            and not e.name.startswith("nccl:")]


STEP_OPTIONS = ("fine_tune_flow_motion", "remat", "accum_steps", "bn_frozen_eval", "skip_nonfinite_updates")


def add_step_option_args(ap: argparse.ArgumentParser) -> None:
    """The train step's options as flags, with the train CLI's names, and
    ``--steps_per_dispatch``."""
    ap.add_argument("--steps_per_dispatch", type=int, default=1)
    ap.add_argument("--fine_tune_flow_motion", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--skip_nonfinite_updates", action="store_true")
    ap.add_argument("--accum_steps", type=int, default=1)
    ap.add_argument("--bn_frozen_eval", type=lambda v: v.lower() in ("1", "true", "yes"), default=True)


def step_options(args: argparse.Namespace) -> dict:
    """{option: value} of :func:`add_step_option_args`' flags."""
    return {k: getattr(args, k) for k in STEP_OPTIONS}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--trace", type=str, default="")
    ap.add_argument("--mode", type=str, default="TG", choices=["TG", "DS", "DC"])
    ap.add_argument("--d2_score_thresh", type=float, default=0.3)
    add_step_option_args(ap)
    args = ap.parse_args()

    device = resolve_device()
    provider = None
    if args.mode == "TG":
        cfg = Config(height=192, width=640, batch_size=4, mode=Mode.TG, threshold=9.22,
                     w_d2_sim=0.0, compute_dtype="bfloat16", **step_options(args)).validate()
    else:
        from .masks.maskrcnn import MaskRCNNProvider

        cfg = Config(height=192, width=640, batch_size=4, mode=Mode(args.mode), threshold=9.22,
                     compute_dtype="bfloat16", mask_provider="maskrcnn", d2_allow_random_weights=True,
                     d2_score_thresh=args.d2_score_thresh, log_dir=tempfile.mkdtemp(),
                     **step_options(args)).validate()
        provider = MaskRCNNProvider(cfg, device)
    models = T.build_models(cfg, torch.Generator().manual_seed(0), device)
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    gen = torch.Generator(device=device).manual_seed(1)
    colors, K = synthetic_batch(4, 192, 640, seed=0)
    batch = {"colors_u8": torch.from_numpy(colors).to(device), "K": torch.from_numpy(K).to(device)}
    k = args.steps_per_dispatch
    kstep = T.make_multi_train_step(cfg, models, opt, k, provider=provider) if k > 1 else None
    stacked = {key: torch.stack([v] * k) for key, v in batch.items()}
    done = 0  # steps taken: the next dispatch's draws start there

    def run(n: int) -> float:
        """Wall ms per step of ``n`` steps (``n`` dispatches of K steps with
        ``--steps_per_dispatch``) ending in a sync."""
        nonlocal done
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            if kstep is None:
                T.train_step(cfg, models, opt, batch, generator=gen, provider=provider)
            else:
                kstep(stacked, T.multi_step_draws(cfg, stacked, done))
                done += k
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (n * k)

    run(args.warmup if kstep is None else 1)  # with K > 1: the capture and a first replay
    window = args.steps if kstep is None else 1  # with K > 1 a window is one dispatch
    steps = window * k
    plain_ms = [run(window)]
    traces = []
    for _ in range(args.rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as dev_prof:
            dev_step_ms = run(window)
        traces.append((dev_step_ms, _device_kernels(dev_prof)))
        plain_ms.append(run(window))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as host_prof:
        host_step_ms = run(window)

    device_trace = []
    for dev_step_ms, kernels in traces:
        if not kernels:
            raise RuntimeError("the device-only trace holds no kernels")
        busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3 / steps
        device_trace.append({
            "step_ms": dev_step_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / dev_step_ms,
            "kernel_launches_per_step": len(kernels) / steps,
        })
    by_name: dict[str, list[float]] = {}
    for e in traces[0][1]:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]
    stage_ms = dict.fromkeys(T.STAGES, 0.0)
    for e in host_prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in T.STAGES:
            stage_ms[e.name] += e.time_range.elapsed_us() / 1e3 / steps
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        host_prof.export_chrome_trace(os.path.join(args.trace, "train_step_trace.json"))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "profile": f"train_step {args.mode} 640x192 bs4 bf16",
        "step_options": step_options(args),
        "d2_score_thresh": args.d2_score_thresh if provider is not None else None,
        "card": smi,
        "steps_per_dispatch": k,
        "capture_s": kstep.capture_seconds if kstep is not None else None,
        "steps_per_window": steps,
        "step_ms_no_profiler": plain_ms,
        "device_trace": device_trace,
        "top_kernels": [
            {"name": n[:120], "calls_per_step": len(d) / steps, "ms_per_step": sum(d) / 1e3 / steps}
            for n, d in top
        ],
        "host_trace": {"step_ms": host_step_ms, "host_stage_ms_per_step": stage_ms},
    }))


if __name__ == "__main__":
    main()
