"""The Mask R-CNN's box utilities and the plain versions of its two kernels
(NMS, multilevel ROIAlign) and of its paste, against the JAX package's
``mdn_sfm_tpu.masks.maskrcnn`` on the CPU, inputs made from a seed with
numpy. NMS must give identical keep and valid, ties, -inf scores and boxes
without area included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdn_sfm_tpu.masks.maskrcnn as M
from mdn_sfm_tpu_torch.masks import maskrcnn as TM
from mdn_sfm_tpu_torch.ops import nms as N
from mdn_sfm_tpu_torch.ops import roi_align as RA
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

# f32 on both sides; the sub-bin mean and the tap blend may sum in another
# order than XLA's: a few ulp of the features (|x| ≤ ~4)
ROI_F32_ATOL = 1e-5
# bf16 features: the JAX package blends and averages in bf16, the port in
# f32 from the same bf16 taps and rounds once: up to ~6 bf16 roundings of
# values ≤ ~4 (ulp 2^-6 at 2-4), so 4 ulp
ROI_BF16_ATOL = 6.25e-2
# the separable paste: JAX's HIGHEST-precision einsums against two f32 bmm
PASTE_ATOL = 1e-5
PASTE_MARGIN = 1e-5  # binary masks are compared where |p − 0.5| exceeds this


def _np(x):
    return np.asarray(x)


# ------------------------------------------------------------ box utilities


@pytest.mark.parametrize("level", range(5))
def test_anchors_for_level(level):
    stride, size = 2 ** (level + 2), M.ANCHOR_SIZES[level]
    np.testing.assert_array_equal(TM.anchors_for_level(6, 9, stride, size), M.anchors_for_level(6, 9, stride, size))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), M.BOX_REG_WEIGHTS])
def test_decode_boxes(weights):
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 500, (64, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(1, 200, (64, 2))], 1).astype(np.float32)
    deltas = rng.normal(scale=3.0, size=(64, 4)).astype(np.float32)
    deltas[:8, 2:] = 60.0  # beyond the 4.135 clamp
    want = _np(M.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas), weights))
    got = TM.decode_boxes(torch.from_numpy(anchors), torch.from_numpy(deltas), weights).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_clip_boxes_and_iou():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-50, 300, (40, 4)).astype(np.float32)
    want = _np(M.clip_boxes(jnp.asarray(boxes), jnp.float32(120.0), jnp.float32(250.0)))
    np.testing.assert_array_equal(TM.clip_boxes(torch.from_numpy(boxes), 120.0, 250.0).numpy(), want)
    per_image = TM.clip_boxes(torch.from_numpy(boxes).reshape(2, 20, 4), torch.tensor([120.0, 120.0]),
                              torch.tensor([250.0, 250.0]))
    np.testing.assert_array_equal(per_image.reshape(40, 4).numpy(), want)
    a = np.sort(boxes.reshape(40, 2, 2), 1).reshape(40, 4)[:, [0, 2, 1, 3]]
    np.testing.assert_allclose(TM.iou_matrix(torch.from_numpy(a), torch.from_numpy(a)).numpy(),
                               _np(M.iou_matrix(jnp.asarray(a), jnp.asarray(a))), rtol=1e-6, atol=1e-7)


def _level_boxes() -> np.ndarray:
    """Boxes whose √area sits on, just below and just above each level
    boundary 224·2^k (k = -1, 0, 1), squares and 2:1 ones, plus empty,
    degenerate and huge boxes."""
    out = []
    for k in (-1, 0, 1):
        s = 224.0 * 2.0**k
        for d in (-1.0, -1e-3, 0.0, 1e-3, 1.0):
            out.append((10.0, 20.0, 10.0 + s + d, 20.0 + s + d))
            out.append((5.0, 5.0, 5.0 + (s + d) * 2 ** 0.5, 5.0 + (s + d) / 2 ** 0.5))
    out += [(0, 0, 0, 0), (3, 3, 1, 1), (0, 0, 2000, 600), (1, 1, 2, 2)]
    return np.asarray(out, np.float32)


def test_assign_fpn_level_on_boundaries():
    boxes = _level_boxes()
    want = _np(M.assign_fpn_level(jnp.asarray(boxes)))
    got = RA.assign_fpn_level(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(want.tolist()) == {2, 3, 4, 5}


# --------------------------------------------------------------------- NMS


def _nms_case(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 90, (n, 2))], 1).astype(np.float32)
    scores = rng.normal(size=n).astype(np.float32)
    if kind == "ties":          # thresholded to 0, as the class stage does
        scores = np.where(scores > 0.8, scores, 0.0).astype(np.float32)
        scores[5:9] = scores[4]
    elif kind == "neg_inf":     # invalid candidates end the valid run
        scores[rng.random(n) < 0.6] = -np.inf
    elif kind == "no_area":     # a top box without area is kept again and again
        boxes[3, 2] = boxes[3, 0]
        scores[3] = scores.max() + 1.0
    elif kind == "level_offset":  # identical boxes in two levels both survive
        boxes[n // 2:] = boxes[: n - n // 2]
        boxes[n // 2:] += (M.MAX_SIZE_TEST * 2.0)
    return boxes, scores


@pytest.mark.parametrize("kind,n,max_out,thresh", [
    ("random", 300, 64, 0.7), ("random", 200, 200, 0.5), ("ties", 256, 32, 0.5),
    ("neg_inf", 120, 80, 0.7), ("no_area", 50, 12, 0.5), ("level_offset", 80, 40, 0.7),
])
def test_nms_plain_equals_nms_fixed(kind, n, max_out, thresh):
    cases = [_nms_case(kind, n, seed) for seed in range(3)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    keep, valid = N.nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, max_out)
    assert keep.dtype == torch.int32 and valid.dtype == torch.bool and keep.shape == (3, max_out)
    for i in range(3):
        jk, jv = M.nms_fixed(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thresh, max_out)
        np.testing.assert_array_equal(keep[i].numpy(), _np(jk), err_msg=f"{kind} image {i}")
        np.testing.assert_array_equal(valid[i].numpy(), _np(jv), err_msg=f"{kind} image {i}")
    if kind == "no_area":
        assert (keep[:, 1:].numpy() == 3).all()
    if kind == "neg_inf":
        assert not valid.all() and valid.any()


def test_nms_refuses_other_devices_and_shapes():
    with pytest.raises(ValueError, match="N, n, 4"):
        N.nms(torch.zeros(4, 4), torch.zeros(4), 0.5, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        N.nms(torch.zeros(1, 4, 4, device="meta"), torch.zeros(1, 4, device="meta"), 0.5, 2)


# ---------------------------------------------------------------- ROIAlign

LEVEL_HW = ((32, 48), (16, 24), (8, 12), (4, 6))  # P2..P5 of a 128×192 input


def _roi_inputs(seed: int, n_img: int = 2, n_box: int = 24):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(n_img, h, w, 16)).astype(np.float32) for h, w in LEVEL_HW]
    xy = rng.uniform(-10, 180, (n_img, n_box, 2))
    wh = np.exp(rng.uniform(0, 5.7, (n_img, n_box, 2)))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    lb = _level_boxes()
    boxes[0, : len(lb)] = lb[:n_box]                    # on the level boundaries
    boxes[1, :3] = [[0, 0, 0, 0], [-20, -20, 300, 300], [127.5, 3.0, 191.9, 120.0]]  # clipped taps
    return feats, boxes


@pytest.mark.parametrize("out_size", [7, 14])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_plain_matches_jax_gather(dtype, out_size):
    feats, boxes = _roi_inputs(seed=out_size)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    got = RA.multilevel_roi_align([torch.from_numpy(f).to(tdt) for f in feats], torch.from_numpy(boxes), out_size)
    assert got.dtype == tdt and got.shape == (2, boxes.shape[1], out_size, out_size, 16)
    for i in range(2):
        want = M.multilevel_roi_align_gather([jnp.asarray(f[i]).astype(jdt) for f in feats],
                                             jnp.asarray(boxes[i]), out_size)
        np.testing.assert_allclose(got[i].float().numpy(), np.asarray(want, np.float32),
                                   atol=ROI_F32_ATOL if dtype == "float32" else ROI_BF16_ATOL, rtol=0)


def test_roi_align_plain_reads_any_strides():
    """The networks' NCHW features viewed as NHWC, and chunks of boxes, give
    the dense result."""
    feats, boxes = _roi_inputs(seed=3, n_box=40)
    dense = RA.roi_align_reference([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), 7)
    views = [torch.from_numpy(f).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) for f in feats]
    old = RA._CHUNK_ELEMENTS
    try:
        RA._CHUNK_ELEMENTS = 2 * 14 * 14 * 16 * 3  # 3 boxes a chunk
        chunked = RA.roi_align_reference(views, torch.from_numpy(boxes), 7)
    finally:
        RA._CHUNK_ELEMENTS = old
    assert torch.equal(dense, chunked)


# ------------------------------------------------------------------- paste


def _paste_inputs(seed: int):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(2, 6, 28, 28)).astype(np.float32)
    boxes = np.stack([rng.uniform(-10, 40, (2, 6)), rng.uniform(-5, 30, (2, 6)),
                      rng.uniform(50, 110, (2, 6)), rng.uniform(40, 70, (2, 6))], -1).astype(np.float32)
    valid = rng.random((2, 6)) < 0.7
    return masks, boxes, valid


def test_paste_matches_jax():
    masks, boxes, _ = _paste_inputs(5)
    got = TM.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), 64, 96)
    assert got.shape == (2, 6, 64, 96)
    for i in range(2):
        want = _np(M.paste_masks(jnp.asarray(masks[i]), jnp.asarray(boxes[i]), 64, 96))
        np.testing.assert_allclose(got[i].numpy(), want, atol=PASTE_ATOL, rtol=0)


def test_paste_threshold_union_ready_matches_jax():
    masks, boxes, valid = _paste_inputs(6)
    det = TM.Detections(torch.from_numpy(boxes), None, None, torch.from_numpy(masks), torch.from_numpy(valid))
    got = TM.paste_threshold_union_ready(det, det.boxes / 2.0, 32, 48).numpy()
    pasted = TM.paste_masks(det.masks28, det.boxes / 2.0, 32, 48).numpy()
    for i in range(2):
        jdet = M.Detections(jnp.asarray(boxes[i]), None, None, jnp.asarray(masks[i]), jnp.asarray(valid[i]))
        want = _np(M.paste_threshold_union_ready(jdet, jdet.boxes / 2.0, 32, 48))
        clear = np.abs(pasted[i] - 0.5) > PASTE_MARGIN
        np.testing.assert_array_equal(got[i][clear], want[clear])
        assert not got[i][~valid[i]].any()


def test_distinct_taps_counts_each_feature_pixel_once():
    """What a ROIAlign over the boxes must read: the distinct (image, level,
    y, x) its taps touch, counted by hand from the JAX package's sample
    points (``_roi_sample_box``'s arithmetic in numpy)."""
    _, boxes = _roi_inputs(seed=9, n_box=12)
    lvl = np.asarray(M.assign_fpn_level(jnp.asarray(boxes.reshape(-1, 4)))).reshape(2, -1) - 2
    seen = set()
    n = 7 * 2
    for i in range(2):
        for r in range(boxes.shape[1]):
            li = lvl[i, r]
            h, w = LEVEL_HW[li]
            x1, y1, x2, y2 = (boxes[i, r] / np.float32(2.0 ** (li + 2))).tolist()
            k = np.arange(n, dtype=np.float32) + np.float32(0.5)
            ys = np.float32(y1) + k * np.float32(max(y2 - y1, 1e-6)) / np.float32(n) - np.float32(0.5)
            xs = np.float32(x1) + k * np.float32(max(x2 - x1, 1e-6)) / np.float32(n) - np.float32(0.5)
            for yy in (np.floor(ys), np.floor(ys) + 1):
                for xx in (np.floor(xs), np.floor(xs) + 1):
                    for a in np.clip(yy.astype(int), 0, h - 1):
                        for b in np.clip(xx.astype(int), 0, w - 1):
                            seen.add((i, li, a, b))
    assert RA.distinct_taps(torch.from_numpy(boxes), LEVEL_HW, 7) == len(seen)
