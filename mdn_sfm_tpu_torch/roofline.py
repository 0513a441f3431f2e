"""Roofline of the train step on the card: counted work against measured
time — the port of ``tools/roofline.py``.

The JAX tool reads XLA's cost analysis of the compiled step. The port counts
the step's work on one eager ``training.train_step`` of the same
configuration and batch, before any graph is captured:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, the convolution and
  matmul FLOPs of the forward and the backward (elementwise work is not
  counted);
* bytes: :class:`ByteCounter`, for each ATen op the bytes of its tensor
  inputs, each read once, and of its outputs, each written once; an op
  whose outputs are views of an input moves nothing. This is the traffic of
  the ATen ops as issued, not of a fused program: XLA counts its ``bytes
  accessed`` after fusion, so the two are not comparable, and L2 can serve
  part of it, so a share of the card's memory rate above 1 can be read;
* the port's kernels (epipolar, and with a fused Mask R-CNN NMS and
  ROIAlign) launch through ctypes, unseen by both counters: their work is
  added by the formulas their bounds use (:func:`epipolar_work`,
  :func:`nms_work`, :func:`roi_align_work`) and listed apart.

It times the step as ``chip_smoke.py`` phase 10 does: K steps a dispatch
(``dispatch.KStepDispatch``), one warm dispatch, then the median over timed
dispatches of a dispatch's host clock, draws and copies included, to a
sync, over K. Shares are of the card's published dense peaks (:data:`PEAKS`,
every FLOP against the bf16 rate), with the card's power limit beside them.
It runs on the card only and raises without one or on a card the table
lacks.

    python -m mdn_sfm_tpu_torch.roofline [--mode TG] [--height 192 --width 640 --batch 4] [--k_steps 16]

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import time
from typing import Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s,
# bf16 tensor-core FLOP/s and float32 FLOP/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_F32_FLOP_PER_S = 67e12
# part: (bf16 FLOP/s, HBM bytes/s), and the part of each card by its name
PEAKS = {"h100-sxm": (PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S)}
PARTS = {"NVIDIA H100 80GB HBM3": "h100-sxm"}
# the epipolar map per pixel: F·p1 (12), p2 (2), l·p2 (4), the norm (6),
# divide + abs (2)
EPI_FLOP_PER_PX = 26
# one IoU (areas, intersection, union, divide) and one ROIAlign output value
# (4 sub-bins × (8 mul, 3 add, 2 sub, 1 acc), the mean) in f32 operations
NMS_IOU_FLOP = 18
ROI_FLOP_PER_OUTPUT = 57
TIMED_DISPATCHES = 5  # chip_smoke.py phase 10's


# ------------------------------------------------------------ kernels' work


def epipolar_work(maps) -> tuple[int, int]:
    """(bytes, FLOPs) of the epipolar maps: each flow read once, each map
    written once and the pose tables (inv_K, R, t: 21 floats an image),
    against ``EPI_FLOP_PER_PX`` a pixel."""
    px = sum(m.flow[..., 0].numel() for m in maps)
    images = sum(m.flow.shape[0] for m in maps)
    return px * (2 * 4 + 4) + images * (9 + 9 + 3) * 4, px * EPI_FLOP_PER_PX


def nms_work(boxes, scores, keep, valid) -> tuple[int, int]:
    """(bytes, FLOPs) of one NMS stage: its inputs read and outputs written
    once, against the IoUs this data needs (each kept box against every box
    after it in score order)."""
    n_img, n, _ = boxes.shape
    nbytes = n_img * n * (16 + 4) + keep.numel() * (4 + 1)
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(n, device=order.device).expand(n_img, n).contiguous())
    ious = int(((n - rank.gather(1, keep.long())) * valid).sum())
    return nbytes, ious * NMS_IOU_FLOP


def roi_align_work(feats, boxes, out_size, sampling: int = 2) -> tuple[int, int]:
    """(bytes, FLOPs) of one ROIAlign: the feature pixels its taps touch and
    the boxes read once, the output written once, against its blend
    operations."""
    from .ops import roi_align as RA

    n_img, n_box, _ = boxes.shape
    c, item = feats[0].shape[-1], feats[0].element_size()
    taps = RA.distinct_taps(boxes, [(f.shape[1], f.shape[2]) for f in feats], out_size, sampling)
    outputs = n_img * n_box * out_size * out_size * c
    return taps * c * item + boxes.numel() * 4 + outputs * item, outputs * ROI_FLOP_PER_OUTPUT


@contextlib.contextmanager
def kernel_calls():
    """Within the block, each call of the three kernel entries on the step's
    path (the loss's epipolar maps, the Mask R-CNN's NMS and ROIAlign) is
    recorded with the tensors it took and gave: {"epipolar": [maps],
    "nms": [(boxes, scores, keep, valid)], "roi_align": [(feats, boxes,
    out_size, sampling)]}, for :func:`kernel_work` after the block."""
    from . import losses
    from .masks import maskrcnn

    calls = {"epipolar": [], "nms": [], "roi_align": []}
    real = (losses.epipolar_abs_residual_maps, maskrcnn.nms, maskrcnn.multilevel_roi_align)

    def epipolar(maps):
        calls["epipolar"].append(list(maps))
        return real[0](maps)

    def nms(boxes, scores, thresh, max_out):
        keep, valid = real[1](boxes, scores, thresh, max_out)
        calls["nms"].append((boxes, scores, keep, valid))
        return keep, valid

    def roi_align(feats, boxes, out_size, sampling=2):
        calls["roi_align"].append((list(feats), boxes, out_size, sampling))
        return real[2](feats, boxes, out_size, sampling)

    losses.epipolar_abs_residual_maps, maskrcnn.nms, maskrcnn.multilevel_roi_align = epipolar, nms, roi_align
    try:
        yield calls
    finally:
        losses.epipolar_abs_residual_maps, maskrcnn.nms, maskrcnn.multilevel_roi_align = real


def kernel_work(calls: dict) -> dict:
    """{kernel: {"launches", "bytes", "flops"}} of :func:`kernel_calls`'
    record (the epipolar entry with its "maps")."""
    work = {"epipolar": [epipolar_work(m) for m in calls["epipolar"]],
            "nms": [nms_work(*c) for c in calls["nms"]],
            "roi_align": [roi_align_work(*c) for c in calls["roi_align"]]}
    out = {k: {"launches": len(w), "bytes": sum(b for b, _ in w), "flops": sum(f for _, f in w)}
           for k, w in work.items()}
    out["epipolar"]["maps"] = sum(len(m) for m in calls["epipolar"])
    return out


# ------------------------------------------------------------ ATen counters


def _stored_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a broadcast dimension, stride
    0, holds one)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


class ByteCounter(TorchDispatchMode):
    """The bytes the ATen ops within the block move: for each op its tensor
    inputs, each read once, and its outputs, each written once (an in-place
    op reads and writes its target). An op whose outputs are views of an
    input (``view``, ``permute``, ``as_strided``, ``expand``, …) moves
    nothing, and ``empty`` writes nothing. :attr:`bytes` and :attr:`ops`
    (the ops counted) add up."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func) and not func.overloadpacket.__name__.startswith("empty"):
            inputs = {id(t): t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
            outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            self.bytes += sum(map(_stored_bytes, inputs.values())) + sum(map(_stored_bytes, outputs))
            self.ops += 1
        return out


def count_step(cfg, models, opt, batch: dict, generator: torch.Generator, provider=None) -> dict:
    """The work of one eager ``training.train_step`` on ``batch`` (it trains):
    {"aten_flops", "aten_bytes", "aten_ops", "kernels": :func:`kernel_work`,
    "flops", "bytes"} with the kernels' work added in the last two. On the
    card only the kernels' formulas see their work; on the CPU their plain
    versions' ATen ops are counted too."""
    from torch.utils.flop_counter import FlopCounterMode

    from . import training as T

    with kernel_calls() as calls, FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        T.train_step(cfg, models, opt, batch, generator=generator, provider=provider)
    kernels = kernel_work(calls)
    total_flops = flops.get_total_flops() + sum(k["flops"] for k in kernels.values())
    total_bytes = nbytes.bytes + sum(k["bytes"] for k in kernels.values())
    return {"aten_flops": flops.get_total_flops(), "aten_bytes": nbytes.bytes, "aten_ops": nbytes.ops,
            "kernels": kernels, "flops": total_flops, "bytes": total_bytes}


# ----------------------------------------------------------- the timed step


def step_config(mode: str, batch: int, height: int, width: int, remat: bool = False, accum: int = 1,
                fine_tune: bool = False):
    """The JAX tools' step configuration: ``mode`` at ``height``×``width``,
    bf16, threshold 9.22, no d2 similarity; DS/DC with the live Mask R-CNN
    fused into the step (random weights, 32 instances)."""
    from .config import Config, Mode

    extra = {}
    if Mode[mode] in (Mode.DS, Mode.DC):
        extra = dict(mask_provider="maskrcnn", d2_allow_random_weights=True, d2_max_instances=32)
    return Config(height=height, width=width, batch_size=batch, mode=Mode[mode], threshold=9.22, w_d2_sim=0.0,
                  compute_dtype="bfloat16", remat=remat, accum_steps=accum, fine_tune_flow_motion=fine_tune,
                  **extra).validate()


def build_step(cfg, device: torch.device, k: int):
    """(models, optimizer, provider or None, K batches (K, B, …) on
    ``device``) for ``cfg``: nets from seed 0, the synthetic batches of
    seed 0."""
    from . import training as T
    from .data.synthetic import synthetic_batch

    models = T.build_models(cfg, torch.Generator().manual_seed(0), device)
    opt = T.make_optimizer(cfg, models, steps_per_epoch=1000)
    provider = None
    if cfg.mask_provider == "maskrcnn":
        from .masks.maskrcnn import MaskRCNNProvider

        provider = MaskRCNNProvider(cfg, device)
    colors, K = synthetic_batch(cfg.batch_size * k, cfg.height, cfg.width, seed=0)
    batches = {"colors_u8": torch.from_numpy(colors.reshape(k, cfg.batch_size, *colors.shape[1:])).to(device),
               "K": torch.from_numpy(K.reshape(k, cfg.batch_size, 4, 4)).to(device)}
    return models, opt, provider, batches


def time_dispatches(cfg, kstep, batches: dict, rounds: int) -> tuple[list[float], tuple]:
    """One warm dispatch (the capture on the card's first), then ``rounds``
    timed: each dispatch's host clock, draws and copies included, to a
    sync, over K, in seconds; and the last dispatch's (metrics, aux)."""
    from . import training as T

    k = kstep.k
    step = 0

    def dispatch():
        nonlocal step
        out = kstep(batches, T.multi_step_draws(cfg, batches, step))
        step += k
        return out

    float(dispatch()[0]["loss"])
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = dispatch()
        if kstep.device.type == "cuda":
            torch.cuda.synchronize(kstep.device)
        times.append((time.perf_counter() - t0) / k)
    return times, out


# --------------------------------------------------------------------- CLI


def peaks(chip: str | None, device_name: str) -> tuple[str, float, float]:
    """(part, bf16 FLOP/s, bytes/s) of ``chip``, or of the card named
    ``device_name`` when ``chip`` is None. Raises ``ValueError`` for a part
    or a card the table lacks."""
    if chip is None:
        if device_name not in PARTS:
            raise ValueError(f"no published peaks for the card {device_name!r}; known cards: {sorted(PARTS)}")
        chip = PARTS[device_name]
    if chip not in PEAKS:
        raise ValueError(f"no published peaks for the part {chip!r}; known parts: {sorted(PEAKS)}")
    return (chip, *PEAKS[chip])


def card_name_and_power_limit() -> tuple[str, float]:
    """``nvidia-smi --query-gpu=name,power.limit``'s line for the first card:
    (the line, the limit in W)."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return line, float(line.rsplit(",", 1)[1].split()[0])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="TG")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--k_steps", type=int, default=16)
    p.add_argument("--chip", default=None, help=f"one of {sorted(PEAKS)} (default: the card's own)")
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from . import training as T
    from .utils import resolve_device

    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(device)
    chip, peak_flops, peak_bytes = peaks(args.chip, name)
    smi, power_limit_w = card_name_and_power_limit()

    cfg = step_config(args.mode, args.batch, args.height, args.width)
    models, opt, provider, batches = build_step(cfg, device, args.k_steps)
    counted = count_step(cfg, models, opt, {key: v[0] for key, v in batches.items()},
                         T.step_generator(cfg.seed, 0, device), provider)
    kstep = T.make_multi_train_step(cfg, models, opt, args.k_steps, provider)
    times, _ = time_dispatches(cfg, kstep, batches, TIMED_DISPATCHES)
    dt = statistics.median(times)

    util_compute = counted["flops"] / dt / peak_flops
    util_bw = counted["bytes"] / dt / peak_bytes
    result = {
        "mode": args.mode, "shape": f"{args.height}x{args.width} bs{args.batch}", "step_ms": 1e3 * dt,
        "frames_per_s": args.batch / dt, "gflops_per_step": counted["flops"] / 1e9,
        "hbm_mb_per_step": counted["bytes"] / 1e6, "achieved_tflops": counted["flops"] / dt / 1e12,
        "achieved_hbm_gbs": counted["bytes"] / dt / 1e9, "chip": chip, "util_compute": util_compute,
        "util_bandwidth": util_bw, "bound": "compute" if util_compute > util_bw else "bandwidth",
        "roofline_fraction": max(util_compute, util_bw), "power_limit_w": power_limit_w, "device": name,
        "nvidia_smi": smi, "k_steps": args.k_steps, "step_ms_timed": [1e3 * t for t in times],
        "capture_s": kstep.capture_seconds,
        "counted": {"aten_gflops": counted["aten_flops"] / 1e9, "aten_mb": counted["aten_bytes"] / 1e6,
                    "aten_ops": counted["aten_ops"], "kernels": counted["kernels"]},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
