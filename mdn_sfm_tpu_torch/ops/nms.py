"""Batched greedy NMS with a static output size: the CUDA kernel
``csrc/nms.cu`` and its plain PyTorch version.

The counterpart of ``mdn_sfm_tpu/masks/maskrcnn.py::nms_fixed`` (an XLA
``fori_loop`` of argmax/suppress rounds), batched over images: one call
runs an NMS stage for the whole batch (the kernel's sort, mask and scan).
The tensors' device chooses: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

Tensor = torch.Tensor

_PTR = ctypes.c_void_p
_I32 = ctypes.c_int32

# the kernel's limit (csrc/nms.cu kMaxBoxes): the sort's keys in one block's
# shared memory; the suppression mask is then 8 MiB an image
MAX_BOXES = 8192


def iou_rows(chosen: Tensor, boxes: Tensor) -> Tensor:
    """IoU of each image's chosen box (N, 4) against its boxes (N, n, 4), as
    ``maskrcnn.iou_matrix`` computes a row of it: (N, n)."""
    def area(b):
        return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)

    a = chosen[:, None, :]
    wh = (torch.minimum(a[..., 2:], boxes[..., 2:]) - torch.maximum(a[..., :2], boxes[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a) + area(boxes) - inter + 1e-12)


def nms_reference(boxes: Tensor, scores: Tensor, iou_thresh: float, max_out: int) -> tuple[Tensor, Tensor]:
    """Plain version: ``nms_fixed`` round by round, over a batch.

    Each round takes the argmax of the alive scores (ties to the lower index),
    keeps it if its score is above -inf, and retires every box whose IoU with
    it exceeds ``iou_thresh`` (itself included, unless it has no area).
    Returns (keep (N, max_out) int32, valid (N, max_out) bool); invalid slots
    hold index 0."""
    n_img, n, _ = boxes.shape
    rows = torch.arange(n_img, device=boxes.device)
    alive = torch.ones(n_img, n, dtype=torch.bool, device=boxes.device)
    keep = torch.zeros(n_img, max_out, dtype=torch.int32, device=boxes.device)
    valid = torch.zeros(n_img, max_out, dtype=torch.bool, device=boxes.device)
    neg_inf = torch.full((), float("-inf"), device=boxes.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        j = masked.argmax(1)
        ok = masked[rows, j] > float("-inf")
        keep[:, i] = torch.where(ok, j, 0).int()
        valid[:, i] = ok
        iou = iou_rows(boxes[rows, j], boxes)
        alive = torch.where(ok[:, None], alive & (iou <= iou_thresh), alive)
    return keep, valid


def _kernel_fn():
    fn = _build.load("nms").nms_fixed_f32
    if fn.argtypes is None:
        fn.argtypes = [_PTR, _PTR, _I32, _I32, _I32, ctypes.c_float, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]
        fn.restype = ctypes.c_int
    return fn


def nms(boxes: Tensor, scores: Tensor, iou_thresh: float, max_out: int) -> tuple[Tensor, Tensor]:
    """Greedy NMS per image with a static output size.

    Args:
        boxes: (N, n, 4) float32 XYXY, already offset by level or class as
            the callers do (the batched-NMS trick).
        scores: (N, n) float32.
    Returns:
        (keep (N, max_out) int32, valid (N, max_out) bool), identical to
        ``nms_fixed`` per image.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    three stages once for the batch (sort, mask, scan; one call counted in
    ``nms.launches``) or raise.
    """
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes must be (N, n, 4) and scores (N, n), got {tuple(boxes.shape)} "
                         f"and {tuple(scores.shape)}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if boxes.device.type == "cpu":
        return nms_reference(boxes, scores, iou_thresh, max_out)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise ValueError(f"the NMS kernel takes float32, got {boxes.dtype} and {scores.dtype}")
    n_img, n, _ = boxes.shape
    if not 1 <= n <= MAX_BOXES:
        raise ValueError(f"the NMS kernel takes 1 to {MAX_BOXES} boxes an image, got {n}")
    boxes, scores = boxes.contiguous(), scores.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one 16-byte load
        boxes = boxes.clone()
    dev = boxes.device
    keep = torch.empty(n_img, max_out, dtype=torch.int32, device=dev)
    valid = torch.empty(n_img, max_out, dtype=torch.bool, device=dev)
    if n_img and max_out:
        # scratch of the three launches: each position's box index, the
        # sorted boxes, the count of scores above -inf, the suppression mask
        order = torch.empty(n_img, n, dtype=torch.int32, device=dev)
        sboxes = torch.empty(n_img, n, 4, dtype=torch.float32, device=dev)
        limits = torch.empty(n_img, dtype=torch.int32, device=dev)
        mask = torch.empty(n_img, n, (n + 31) // 32, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel_fn()(boxes.data_ptr(), scores.data_ptr(), n_img, n, max_out, float(iou_thresh),
                               keep.data_ptr(), valid.data_ptr(), order.data_ptr(), sboxes.data_ptr(),
                               limits.data_ptr(), mask.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"NMS kernel launch failed: CUDA error {err}")
        nms.launches += 1
    return keep, valid


nms.launches = 0
