"""Batch-size / remat scaling study of the train step on the card — the port
of ``tools/bench_scaling.py``.

For each (batch size, remat, accum_steps): build the configuration (DS/DC
with the live Mask R-CNN fused into the step, as the JAX tool does), capture
K steps a dispatch as one CUDA graph (``dispatch.KStepDispatch``), run one
warm dispatch and ``--rounds`` timed ones, and report frames/s and ms a step
beside the device memory the row took:

* ``hbm_args``: the bytes of the nets' parameters and buffers (the Mask
  R-CNN's too), Adam's state and the K batches, summed from the tensors
  (the JAX tool's XLA argument size);
* ``hbm_temp``: ``torch.cuda.max_memory_allocated()`` over the capture and
  the dispatches, after ``reset_peak_memory_stats()``, less ``hbm_args``;
* ``hbm_out``: the bytes of a dispatch's outputs (its metrics and the last
  step's aux maps).

A row that runs out of device memory (``torch.cuda.OutOfMemoryError``) is a
data point: its error is printed, the graph and the allocator's cache are
freed, and the study goes on. Any other error propagates. On the CPU
(``--device cpu``) the K steps run in turn and the memory fields are null.
Runs on ``cuda`` unless ``--device`` names another device.

    python -m mdn_sfm_tpu_torch.bench_scaling [--bs 4,8,16,32] [--remat off,on]
        [--mode TG] [--fine_tune] [--height 192] [--width 640] [--k 8]
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
from typing import Sequence

import torch
from torch.utils._pytree import tree_leaves


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.2f} GB"


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tensors) if isinstance(t, torch.Tensor))


def run_one(mode_name: str, bs: int, remat: bool, fine_tune: bool, height: int, width: int, k_steps: int,
            rounds: int, accum: int = 1, device: str | torch.device = "cuda") -> dict:
    """One row: the study's configuration at batch ``bs`` on ``device``."""
    from . import training as T
    from .roofline import build_step, step_config, time_dispatches
    from .utils import resolve_device

    device = resolve_device(device)
    cuda = device.type == "cuda"
    cfg = step_config(mode_name, bs, height, width, remat=remat, accum=accum, fine_tune=fine_tune)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    models, opt, provider, batches = build_step(cfg, device, k_steps)
    kstep = T.make_multi_train_step(cfg, models, opt, k_steps, provider)
    times, outputs = time_dispatches(cfg, kstep, batches, rounds)
    dt = statistics.fmean(times)
    row = {"mode": mode_name, "bs": bs, "remat": remat, "accum": accum, "fine_tune": fine_tune,
           "frames_per_s": bs / dt, "ms_per_step": 1e3 * dt, "hbm_temp": None, "hbm_args": None,
           "hbm_out": None, "device": torch.cuda.get_device_name(device) if cuda else str(device)}
    if cuda:
        nets = list(models) + ([provider.model] if provider is not None else [])
        args = (_bytes([list(m.parameters()) + list(m.buffers()) for m in nets]) + _bytes(opt.mu + opt.nu)
                + _bytes(batches))
        row.update(hbm_args=args, hbm_temp=torch.cuda.max_memory_allocated(device) - args,
                   hbm_out=_bytes(outputs))
    return row


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bs", default="4,8,16,32")
    p.add_argument("--remat", default="off", help="comma list of off/on")
    p.add_argument("--accum", default="1", help="comma list of accum_steps")
    p.add_argument("--mode", default="TG")
    p.add_argument("--fine_tune", action="store_true")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--k", type=int, default=8, help="steps per dispatch")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    return p


def main(argv: Sequence[str] | None = None) -> list[dict]:
    args = build_parser().parse_args(argv)

    from .utils import resolve_device

    device = resolve_device(args.device)
    bss = [int(b) for b in args.bs.split(",")]
    remats = [r.strip() == "on" for r in args.remat.split(",")]
    accums = [int(a) for a in args.accum.split(",")]

    rows = []
    for bs in bss:
        for remat in remats:
            for accum in accums:
                try:
                    row = run_one(args.mode, bs, remat, args.fine_tune, args.height, args.width, args.k,
                                  args.rounds, accum=accum, device=device)
                except torch.cuda.OutOfMemoryError as e:  # running out at some batch size is a data point
                    row = {"mode": args.mode, "bs": bs, "remat": remat, "accum": accum,
                           "fine_tune": args.fine_tune, "error": f"{type(e).__name__}: {str(e)[:200]}"}
                gc.collect()  # the row's graph, nets and batches
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                rows.append(row)
                print(json.dumps(row), flush=True)

    print(f"\n{args.mode} {args.height}x{args.width} K={args.k}"
          f"{' fine_tune' if args.fine_tune else ''}")
    print(f"{'bs':>4} {'remat':>6} {'accum':>6} {'f/s':>8} {'ms/step':>8} "
          f"{'HBM temp':>10} {'HBM args':>10}")
    for r in rows:
        if "error" in r:
            print(f"{r['bs']:>4} {str(r['remat']):>6} {r.get('accum', 1):>6}  {r['error']}")
        else:
            print(f"{r['bs']:>4} {str(r['remat']):>6} {r.get('accum', 1):>6} "
                  f"{r['frames_per_s']:>8.1f} "
                  f"{r['ms_per_step']:>8.2f} {_fmt_bytes(r.get('hbm_temp')):>10} "
                  f"{_fmt_bytes(r.get('hbm_args')):>10}")
    return rows


if __name__ == "__main__":
    main()
