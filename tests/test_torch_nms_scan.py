"""The NMS kernel's algorithm (``csrc/nms.cu``), transcribed into plain
PyTorch and numpy here, against the JAX package's ``nms_fixed`` and the
port's ``nms_reference`` on the CPU: the sort of (score, index) keys with the
count of scores above -inf, the suppression mask over the sorted order in
32-bit words (only the words on and right of each row's diagonal word), and
the scan a word at a time (the word's greedy rounds decided in parallel
from its transposed diagonal block, kept rows ORed into the later words).
keep and valid must be identical: ties, -0.0, NaN scores and corners, -inf
scores, boxes without area, duplicates, ``max_out`` past n, n around one word.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdn_sfm_tpu.masks.maskrcnn as M
from mdn_sfm_tpu_torch.ops import nms as N
from test_torch_mask_ops import _nms_case
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NEG_INF_KEY = 0xFF800000  # sort_key's high word of a -inf score; NaN's is 0


def _high_keys(scores: torch.Tensor) -> torch.Tensor:
    """sort_key's high word (~asc) of each score: ascending order is
    descending score, NaN first, -0.0 equal to +0.0; int64."""
    bits = torch.where(scores == 0, torch.zeros_like(scores), scores).view(torch.int32).long() & 0xFFFFFFFF
    asc = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    asc = torch.where(torch.isnan(scores), torch.full_like(asc, 0xFFFFFFFF), asc)
    return ~asc & 0xFFFFFFFF


def _sort(boxes: torch.Tensor, scores: torch.Tensor):
    """nms_sort_kernel for one image: each position's box index, the sorted
    boxes, and how many leading positions score above -inf (0 after a NaN)."""
    high = _high_keys(scores)
    order = torch.sort(high, stable=True).indices  # ties: ascending index
    sorted_high = high[order]
    limit = 0 if int(sorted_high[0]) == 0 else int((sorted_high < NEG_INF_KEY).sum())
    return order, boxes[order], limit


def _mask(sboxes: torch.Tensor, thresh: float) -> np.ndarray:
    """nms_mask_kernel for one image: (n, ⌈n/32⌉) uint32, bit k of row i set
    where !(IoU(i, k) <= thresh), box i first; words left of a row's diagonal
    word are left unwritten (here 0xDEADBEEF, which the scan must not read)."""
    n = sboxes.shape[0]
    nwords = (n + 31) // 32

    def area(b):
        return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)

    a, b = sboxes[:, None, :], sboxes[None, :, :]
    wh = (torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    hit = ~(inter / (area(a) + area(b) - inter + 1e-12) <= thresh)  # (n, n)
    padded = np.zeros((n, nwords * 32), bool)
    padded[:, :n] = hit.numpy()
    weights = (1 << np.arange(32, dtype=np.uint64))
    words = (padded.reshape(n, nwords, 32) * weights).sum(-1).astype(np.uint32)
    below = np.arange(nwords)[None, :] < (np.arange(n) // 32)[:, None]
    words[below] = 0xDEADBEEF
    return words


def _scan(mask: np.ndarray, order: torch.Tensor, limit: int, max_out: int):
    """nms_scan_kernel for one image, lane by lane: keep (max_out,) int32,
    valid (max_out,) bool."""
    n, nwords = mask.shape
    lanes = range(32)
    removed = [0] * nwords
    positions, fill = [], -1
    words = (limit + 31) // 32
    for w in range(words):
        base = 32 * w
        diag = [int(mask[base + j, w]) if base + j < n else 0 for j in lanes]  # lane j: row base + j
        alive = ~removed[w] & 0xFFFFFFFF
        if limit - base < 32:
            alive &= (1 << (limit - base)) - 1
        # the transposed diagonal block: lane j's earlier suppressors
        sup = [sum(((diag[i] >> j) & 1) << i for i in lanes) & ((1 << j) - 1) for j in lanes]
        undecided, kept = alive, 0
        while undecided:
            ins = outs = 0
            for j in lanes:
                if (undecided >> j) & 1:
                    if sup[j] & kept:
                        outs |= 1 << j
                    elif not sup[j] & undecided:
                        ins |= 1 << j
            kept |= ins
            undecided &= ~(ins | outs)
        done = False
        again = kept & ~sum(((diag[j] >> j) & 1) << j for j in lanes)  # kept without area
        if again:
            f = (again & -again).bit_length() - 1
            kept &= (2 << f) - 1
            fill, done = base + f, True
        room = max_out - len(positions)
        if bin(kept).count("1") >= room:
            last = [j for j in lanes if (kept >> j) & 1][room - 1]
            kept &= (2 << last) - 1
            done = True
        rows = [base + j for j in lanes if (kept >> j) & 1]
        positions += rows
        if done:
            break
        for u in range(w + 1, words):
            for r in rows:
                removed[u] |= int(mask[r, u])
    slots = positions + [fill] * (max_out - len(positions))
    keep = np.array([int(order[p]) if p >= 0 else 0 for p in slots], np.int32)
    valid = np.array([p >= 0 for p in slots], bool)
    return keep, valid


def nms_scan(boxes: torch.Tensor, scores: torch.Tensor, thresh: float, max_out: int):
    """The kernel's three stages for one image (n, 4), (n,)."""
    order, sboxes, limit = _sort(boxes, scores)
    return _scan(_mask(sboxes, thresh), order, limit, max_out)


def _case(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind in ("random", "ties", "neg_inf", "no_area", "level_offset"):
        return _nms_case(kind, n, seed)
    boxes, scores = _nms_case("random", n, seed)
    if kind == "nan_score":        # argmax takes the NaN first: nothing is valid
        scores[rng.integers(n)] = np.nan
    elif kind == "nan_corners_top":  # chosen first: its IoU with every box is NaN
        boxes[2, 1] = np.nan
        scores[2] = scores.max() + 1.0
    elif kind == "nan_corners":    # suppressed by whichever box is chosen first
        boxes[rng.integers(n), 2] = np.nan
    elif kind == "all_neg_inf":
        scores[:] = -np.inf
    elif kind == "duplicates":     # equal boxes and scores: the lower index survives
        boxes[n // 2:] = boxes[: n - n // 2]
        scores[n // 2:] = scores[: n - n // 2]
    elif kind == "neg_zero":       # -0.0 ties with +0.0 by index
        scores = np.where(scores > 0.5, scores, 0.0).astype(np.float32)
        scores[::3] = -0.0
    return boxes, scores


CASES = [  # test_torch_mask_ops.py's cases, then the adversarial ones
    ("random", 300, 64, 0.7), ("random", 200, 200, 0.5), ("ties", 256, 32, 0.5),
    ("neg_inf", 120, 80, 0.7), ("no_area", 50, 12, 0.5), ("level_offset", 80, 40, 0.7),
    ("nan_score", 90, 20, 0.5), ("nan_corners_top", 90, 20, 0.5), ("nan_corners", 90, 40, 0.5),
    ("all_neg_inf", 40, 8, 0.5), ("random", 20, 48, 0.5), ("duplicates", 96, 60, 0.5),
    ("neg_zero", 128, 100, 0.5), ("random", 1, 4, 0.5), ("random", 31, 31, 0.3), ("random", 33, 40, 0.3),
]


@pytest.mark.parametrize("kind,n,max_out,thresh", CASES)
def test_nms_scan_equals_nms_fixed(kind, n, max_out, thresh):
    cases = [_case(kind, n, seed) for seed in range(2)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    ref_k, ref_v = N.nms_reference(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, max_out)
    for i in range(2):
        keep, valid = nms_scan(torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), thresh, max_out)
        jk, jv = M.nms_fixed(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thresh, max_out)
        np.testing.assert_array_equal(keep, np.asarray(jk), err_msg=f"{kind} image {i}: keep against nms_fixed")
        np.testing.assert_array_equal(valid, np.asarray(jv), err_msg=f"{kind} image {i}: valid against nms_fixed")
        np.testing.assert_array_equal(keep, ref_k[i].numpy(), err_msg=f"{kind} image {i}: against nms_reference")
        np.testing.assert_array_equal(valid, ref_v[i].numpy(), err_msg=f"{kind} image {i}: against nms_reference")
    if kind in ("nan_score", "all_neg_inf"):
        assert not ref_v.any()
    if kind == "nan_corners_top":
        assert ref_v.sum(1).tolist() == [1, 1]
    if kind == "no_area":
        assert (ref_k[:, 1:] == 3).all()


def test_sort_keys_order_and_count():
    """The keys order NaN first, then descending score, -0.0 with +0.0 by
    index, -inf last; the count stops before -inf and is 0 after a NaN."""
    scores = torch.tensor([0.5, -0.0, float("-inf"), 0.0, 2.0, float("inf"), -3.0, float("-inf")])
    order, _, limit = _sort(torch.zeros(8, 4), scores)
    assert order.tolist() == [5, 4, 0, 1, 3, 6, 2, 7] and limit == 6
    scores[6] = float("nan")
    order, _, limit = _sort(torch.zeros(8, 4), scores)
    assert order.tolist()[0] == 6 and limit == 0
