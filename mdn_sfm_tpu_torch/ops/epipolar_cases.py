"""Inputs of the epipolar kernel at the shapes and layouts the main path gives
it, made from a seed: what ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the kernel against its plain version on."""

from __future__ import annotations

import torch

from ..data.synthetic import synthetic_intrinsics
from ..geometry import invert_intrinsics, rot_from_axisangle, transformation_from_parameters
from .epipolar import EpipolarMap

# the main path: TG, batch 4 at 192×640; its epipolar maps at 4 scales
BATCH, HEIGHT, WIDTH = 4, 192, 640
SCALES = (0, 1, 2, 3)
# the eval CLIs at the same width: a batch of Config.eval_batch_size pairs
EVAL_BATCH = 8


def epi_inputs(b: int, h: int, w: int, seed: int, nchw_view: bool, device="cuda"):
    """(flow, inv_K, R, t): random pixel flow of a few pixels and a KITTI-like
    forward-moving pose. ``nchw_view``: the flow is a (B, H, W, 2) view of an
    NCHW tensor, as the networks lay it out."""
    g = torch.Generator().manual_seed(seed)
    if nchw_view:
        flow = (3.0 * torch.randn(b, 2, h, w, generator=g)).to(device).permute(0, 2, 3, 1)
    else:
        flow = (3.0 * torch.randn(b, h, w, 2, generator=g)).to(device)
    K = torch.from_numpy(synthetic_intrinsics(h, w)).expand(b, 4, 4)
    R = rot_from_axisangle(0.01 * torch.randn(b, 3, generator=g))
    t = torch.tensor([0.0, 0.0, 0.8]) + 0.05 * torch.randn(b, 3, generator=g)
    return flow, invert_intrinsics(K).to(device), R.to(device), t.to(device)


def step_maps(layout: str, b: int, h: int, w: int, seed: int, device="cuda") -> list[EpipolarMap]:
    """The 8 epipolar maps of a train step (2 reference frames × 4 scales)
    with normalized flow, its pixel scale and the raw pose. ``loss``: as the
    loss hands them over, each frame a deinterleaved view of the nets'
    channels-last (2B, Hs, Ws, 2) flow and of a (2B, 4, 4) pose; ``dense``:
    a dense (B, Hs, Ws, 2) tensor a map; ``nchw_view``: a permuted NCHW view."""
    g = torch.Generator().manual_seed(seed)
    cam_all = transformation_from_parameters(
        0.01 * torch.randn(2 * b, 3, generator=g),
        torch.tensor([0.0, 0.0, 0.8]) + 0.05 * torch.randn(2 * b, 3, generator=g)).to(device)
    maps = []
    for s in SCALES:
        hs, ws = h >> s, w >> s
        K = torch.from_numpy(synthetic_intrinsics(h, w)).clone()
        K[:2] /= 2**s
        inv_K = invert_intrinsics(K.expand(b, 4, 4)).to(device)
        nchw = (3.0 * torch.randn(2 * b, 2, hs, ws, generator=g) / torch.tensor([ws, hs]).view(1, 2, 1, 1)).to(device)
        if layout == "loss":
            both = nchw.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        elif layout == "dense":
            both = nchw.permute(0, 2, 3, 1).contiguous()
        else:
            both = nchw.permute(0, 2, 3, 1)
        for fi in range(2):
            if layout == "loss":
                flow = both.reshape((b, 2) + both.shape[1:])[:, fi]
                cam = cam_all.reshape(b, 2, 4, 4)[:, fi]
            else:
                flow, cam = both[fi * b:(fi + 1) * b], cam_all[fi * b:(fi + 1) * b]
            maps.append(EpipolarMap(flow, (float(ws), float(hs)), inv_K, cam[:, :3, :3], cam[:, :3, 3]))
    return maps


def eval_maps(cli: str, b: int, h: int, w: int, seed: int, device="cuda") -> list[EpipolarMap]:
    """The maps of one eval batch. ``mix``: evaluate_mix's one map, the
    nets' channels-last normalized flow with the pose net's cam_T_cam.
    ``flow``: evaluate_flow's two, that map and the GT flow's: dense pixel
    flow with scale (1, 1) and the stereo baseline [I | t] as its pose, t
    the fourth column of KITTI's P_rect_03 (−0.54 m · fx)."""
    g = torch.Generator().manual_seed(seed)
    cam = transformation_from_parameters(
        0.01 * torch.randn(b, 3, generator=g),
        torch.tensor([0.0, 0.0, 0.8]) + 0.05 * torch.randn(b, 3, generator=g)).to(device)
    K = torch.from_numpy(synthetic_intrinsics(h, w))
    inv_K = invert_intrinsics(K.expand(b, 4, 4)).to(device)
    if cli == "flow":  # evaluate_mix hands over (B, 4, 4), evaluate_flow (B, 3, 3)
        inv_K = inv_K[:, :3, :3].contiguous()
    nchw = (3.0 * torch.randn(b, 2, h, w, generator=g) / torch.tensor([w, h]).view(1, 2, 1, 1)).to(device)
    flow = nchw.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    maps = [EpipolarMap(flow, (float(w), float(h)), inv_K, cam[:, :3, :3], cam[:, :3, 3])]
    if cli == "flow":
        gt = (3.0 * torch.randn(b, h, w, 2, generator=g)).to(device)
        M = torch.zeros(b, 3, 4)
        M[:, :, :3] = torch.eye(3)
        M[:, 0, 3] = -0.54 * float(K[0, 0])
        M = M.to(device)
        maps.append(EpipolarMap(gt, (1.0, 1.0), inv_K, M[:, :3, :3], M[:, :3, 3]))
    return maps


def ragged_maps(seed: int, device="cuda") -> list[EpipolarMap]:
    """Odd and even widths in one table: the scalar and vector paths."""
    maps = []
    for i, (b, h, w) in enumerate([(1, 37, 83), (2, 5, 7), (3, 1, 1), (4, 24, 79), (2, 6, 8)]):
        flow, inv_K, R, t = epi_inputs(b, h, w, seed + i, nchw_view=False, device=device)
        flow = (flow / torch.tensor([w, h], device=flow.device)).contiguous()
        maps.append(EpipolarMap(flow, (float(w), float(h)), inv_K, R, t))
    return maps
