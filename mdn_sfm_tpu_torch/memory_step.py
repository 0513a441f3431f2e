"""Which allocations hold the main path's train step at its peak device memory.

    python -m mdn_sfm_tpu_torch.memory_step [--top 15] [--fine_tune_flow_motion] [--remat]
        [--accum_steps 2] [--bn_frozen_eval false] [--skip_nonfinite_updates]
        [--steps_per_dispatch K]

Runs the TG step at 640×192, batch 4, bf16 (random weights from a seed)
through ``training.train_step``: a few warm-up steps, then one step under
``torch.cuda.memory``'s allocation history. Replays that history from the
bytes allocated before the step, finds the peak, and sums the allocations
live there by the port's innermost source lines that made them. With
``--steps_per_dispatch`` K > 1 the history covers the first K-step dispatch
instead: its eager warm-up, the capture of the CUDA graph (whose private
pool then holds what the K steps allocate) and one replay, which allocates
nothing. Prints one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from . import training as T
from .config import Config, Mode
from .profile_step import add_step_option_args, step_options
from .data.synthetic import synthetic_batch
from .utils import resolve_device

_PORT = os.path.dirname(os.path.abspath(__file__))


def _where(frames: list[dict]) -> str:
    """The port's two innermost frames of an allocation, as file:line."""
    port = [f for f in frames if f["filename"].startswith(_PORT) and not f["filename"].endswith("memory_step.py")]
    return " < ".join(f"{os.path.relpath(f['filename'], _PORT)}:{f['line']}" for f in port[:2]) or "outside the port"


def live_at_peak(trace: list[dict], before: int) -> tuple[int, dict[str, list[int]]]:
    """Replay one device's allocation history from ``before`` allocated bytes:
    the peak, and the live allocations there as {where: [bytes, count]}.
    Blocks allocated before the history began count as "before the step"."""
    live: dict[int, tuple[int, str]] = {}
    older = before
    total = peak = before
    at_peak: dict[int, tuple[int, str]] = {}
    older_at_peak = before
    for e in trace:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], _where(e.get("frames", [])))
            total += e["size"]
            if total > peak:
                peak, at_peak, older_at_peak = total, dict(live), older
        elif e["action"] in ("free_requested", "free_completed"):
            if e["addr"] in live:
                total -= live.pop(e["addr"])[0]
            elif e["action"] == "free_requested":
                older -= e["size"]
                total -= e["size"]
    by_where: dict[str, list[int]] = {"before the step": [older_at_peak, 0]}
    for size, where in at_peak.values():
        entry = by_where.setdefault(where, [0, 0])
        entry[0] += size
        entry[1] += 1
    return peak, by_where


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    add_step_option_args(ap)
    args = ap.parse_args()

    device = resolve_device()
    cfg = Config(height=192, width=640, batch_size=4, mode=Mode.TG, threshold=9.22,
                 w_d2_sim=0.0, compute_dtype="bfloat16", **step_options(args)).validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), device)
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    gen = torch.Generator(device=device).manual_seed(1)
    colors, K = synthetic_batch(4, 192, 640, seed=0)
    batch = {"colors_u8": torch.from_numpy(colors).to(device), "K": torch.from_numpy(K).to(device)}
    for _ in range(args.warmup):
        T.train_step(cfg, models, opt, batch, generator=gen)
    torch.cuda.synchronize()
    k = args.steps_per_dispatch

    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000, stacks="python")
    if k > 1:
        stacked = {key: torch.stack([v] * k) for key, v in batch.items()}
        T.make_multi_train_step(cfg, models, opt, k)(stacked, T.multi_step_draws(cfg, stacked, args.warmup))
    else:
        T.train_step(cfg, models, opt, batch, generator=gen)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_stat = torch.cuda.max_memory_allocated()

    peak, by_where = live_at_peak(snap["device_traces"][torch.cuda.current_device()], before)
    top = sorted(by_where.items(), key=lambda kv: -kv[1][0])[:args.top]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "memory": ("train_step TG 640x192 bs4 bf16, one step after warm-up" if k == 1 else
                   f"the first {k}-step dispatch after warm-up: its warm-up, capture and one replay"),
        "steps_per_dispatch": k,
        "step_options": step_options(args),
        "card": smi,
        "allocated_before_step_bytes": before,
        "max_memory_allocated_bytes": peak_stat,
        "replayed_peak_bytes": peak,
        "live_at_peak": [{"where": w, "bytes": b, "allocations": n} for w, (b, n) in top],
    }))


if __name__ == "__main__":
    main()
