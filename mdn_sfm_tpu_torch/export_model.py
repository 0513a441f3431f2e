"""Export the inference forward as a self-contained program
(``torch.export``) — the port of ``tools/export_model.py``.

The JAX tool serializes the flow + pose + mobile forward to a StableHLO
artifact that runs without the model code. The port writes a
``torch.export`` program (``.pt2``): the same forward traced to ATen ops,
the weights inside, which ``torch.export.load`` runs in a process that never
imports this package:

    # export (weights from the reference checkpoint layout)
    python -m mdn_sfm_tpu_torch.export_model --out model.pt2 --height 192 --width 640 \\
        --log_dir log --version v1 --idx 0

    # load and serve with torch alone, on the device it was exported on
    import torch
    forward = torch.export.load("model.pt2").module()
    with torch.no_grad():
        flow, mobile, axisangle, translation = forward(tgt, ref)

The signature is the JAX tool's: (tgt, ref), normalized (B, H, W, 3)
float32, → (flow0 (B, H, W, 2), mobile0 (B, H, W, 1), axisangle (B, 1, 1, 3),
translation (B, 1, 1, 3)) float32, at a fixed batch and resolution (static
shapes), with the values of ``training.eval_forward`` at scale 0: flow's and
pose's running-average BatchNorm, every net in eval mode, bf16 autocast as
the train step applies it. The program is lowered to ATen's inference ops
(``run_decompositions``), so the autocast is written into it as explicit
casts and needs no autocast where it is loaded; ``export_model`` refuses a
bf16 program whose convolutions do not take bf16 inputs. No kernel of the
port lies on this forward, so the program holds no custom op.

A float32 program matches the live forward on the card when the loading
process keeps cuDNN and cuBLAS in full float32, as ``utils.use_full_f32``
does (``torch.backends.cudnn.allow_tf32 = False``,
``torch.backends.cuda.matmul.allow_tf32 = False``): PyTorch's defaults
allow TF32 in cuDNN convolutions.

``--check`` loads the written file again and compares it with the live
forward on the same device. Runs on ``cuda`` unless ``--device`` names
another device.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Sequence

import numpy as np
import torch

from . import training as T
from .utils import resolve_device

CHECK_ATOL = 1e-6  # the JAX tool's round-trip tolerance
CONVOLUTIONS = ("aten.conv2d.default", "aten.convolution.default")


class _Forward(torch.nn.Module):
    def __init__(self, cfg, models: T.ModelBundle):
        super().__init__()
        self.cfg = cfg
        self.flow, self.pose, self.mobile = models

    @torch.no_grad()
    def forward(self, tgt: torch.Tensor, ref: torch.Tensor):
        flows, mobiles, axisangle, translation, _ = T.forward_frame(
            self.cfg, T.ModelBundle(self.flow, self.pose, self.mobile), tgt, ref, train=False)
        return flows[0], mobiles[0], axisangle, translation


def build_forward(cfg, models: T.ModelBundle) -> torch.nn.Module:
    """(tgt, ref) → (flow0, mobile0, axisangle, translation), with no graph:
    the module that is exported. It holds ``models``' own nets and puts them
    in eval mode."""
    return _Forward(cfg, models).eval()


def conv_input_dtypes(program: torch.export.ExportedProgram) -> dict[str, tuple[torch.dtype, ...]]:
    """{convolution node: dtypes of its input and weight}, from the nodes'
    metadata."""
    return {n.name: tuple(a.meta["val"].dtype for a in n.args[:2]) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target) in CONVOLUTIONS}


def copies(program: torch.export.ExportedProgram) -> list[str]:
    """The program's nodes that copy a tensor other than to change its dtype
    (``clone``, ``contiguous``, a ``_to_copy`` to another layout or
    device): a copy the eager forward does not make."""
    out = []
    for n in program.graph.nodes:
        target = str(n.target)
        if n.op == "call_function" and ("clone" in target or "contiguous" in target or (
                "_to_copy" in target and set(n.kwargs) - {"dtype"})):
            out.append(n.name)
    return out


def export_model(cfg, models: T.ModelBundle, batch: int, device=None) -> torch.export.ExportedProgram:
    """The forward of ``models`` (on ``device``) exported at (batch,
    cfg.height, cfg.width, 3), lowered to ATen's inference ops. Raises
    ``RuntimeError`` when ``cfg`` computes in bf16 and a convolution of the
    program does not: this torch did not record the autocast."""
    device = resolve_device(device)
    forward = build_forward(cfg, models)
    tgt, ref = (torch.zeros(batch, cfg.height, cfg.width, 3, device=device) for _ in range(2))
    program = torch.export.export(forward, (tgt, ref), strict=False).run_decompositions({})
    if cfg.compute_dtype == "bfloat16":
        f32 = {n: d for n, d in conv_input_dtypes(program).items() if d != (torch.bfloat16, torch.bfloat16)}
        if f32:
            name, dtypes = next(iter(f32.items()))
            raise RuntimeError(
                f"torch.export (torch {torch.__version__}) did not record the bf16 autocast: {len(f32)} "
                f"convolutions take {dtypes} inputs (first: {name}); refusing a float32 program for a "
                "bfloat16 config")
    return program


def round_trip(cfg, models: T.ModelBundle, path: str, batch: int, device) -> dict:
    """The program at ``path`` loaded again and run on one random pair
    beside the live forward on ``device``: {"load_s", "max_abs_err": per
    output}. Raises ``AssertionError`` past ``CHECK_ATOL``."""
    rng = np.random.default_rng(0)
    tgt, ref = (torch.from_numpy(rng.normal(size=(batch, cfg.height, cfg.width, 3)).astype(np.float32)).to(device)
                for _ in range(2))
    live = build_forward(cfg, models)(tgt, ref)
    t0 = time.perf_counter()
    loaded = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        got = loaded(tgt, ref)
    errs = [float((a - b).abs().max()) for a, b in zip(got, live)]
    if max(errs) > CHECK_ATOL:
        raise AssertionError(f"the loaded program differs from the live forward: max abs err {errs} > {CHECK_ATOL}")
    return {"load_s": load_s, "max_abs_err": errs}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--log_dir", default="log")
    p.add_argument("--weights_version", default="v0")
    p.add_argument("--idx", type=int, default=0)
    p.add_argument("--version", default="",
                   help="mobile-decoder checkpoint version (default: same folder)")
    p.add_argument("--device", type=str, default="cuda", help="default: cuda")
    p.add_argument("--check", action="store_true",
                   help="round-trip the artifact against the live forward")
    return p


def main(argv: Sequence[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)

    from . import checkpoints as ckpt
    from .config import Config

    device = resolve_device(args.device)
    cfg = Config(height=args.height, width=args.width, batch_size=args.batch,
                 compute_dtype="bfloat16").validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), device)
    mods = T.modules_by_name(models)
    folder = ckpt.weights_folder(args.log_dir, args.weights_version, args.idx)
    if os.path.isdir(folder):
        ckpt.load_into(folder, mods, ("flownet", "posenet", "mobile_decoder"))
        print(f"loaded weights from {folder}")
        if args.version:
            mfolder = ckpt.weights_folder(args.log_dir, args.version, args.idx)
            ckpt.load_into(mfolder, mods, ("mobile_decoder",))
            print(f"loaded mobile_decoder from {mfolder}")
    else:
        print(f"WARNING: {folder} not found — exporting randomly initialized weights")

    t0 = time.perf_counter()
    program = export_model(cfg, models, args.batch, device)
    export_s = time.perf_counter() - t0
    torch.export.save(program, args.out)
    result = {"out": args.out, "bytes": os.path.getsize(args.out), "export_s": export_s, "device": str(device),
              "compute_dtype": cfg.compute_dtype}
    if args.check:
        try:
            result["check"] = round_trip(cfg, models, args.out, args.batch, device)
        except AssertionError:
            os.remove(args.out)
            raise
        print("round-trip check ok")
    print(f"wrote {args.out} ({result['bytes'] / 1e6:.1f} MB, device={device})")
    return result


if __name__ == "__main__":
    main()
