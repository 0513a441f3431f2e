"""Visualization and image IO — the port's own copy of ``mdn_sfm_tpu.viz``:
Middlebury flow colorization, the KITTI flow-error map, image normalization,
box drawing, KITTI 16-bit flow PNG reading, image writing and result files.
Vectorized numpy; ``cv2`` and ``PIL`` are imported only by the functions that
need them (images are written with PIL: the card's machine has no imageio).
"""

from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7

# KITTI flow-error colour table: [lo, hi) of the normalized error → RGB
_LC = np.array(
    [
        [0, 0.0625, 49, 54, 149],
        [0.0625, 0.125, 69, 117, 180],
        [0.125, 0.25, 116, 173, 209],
        [0.25, 0.5, 171, 217, 233],
        [0.5, 1, 224, 243, 248],
        [1, 2, 254, 224, 144],
        [2, 4, 253, 174, 97],
        [4, 8, 244, 109, 67],
        [8, 16, 215, 48, 39],
        [16, 1e9, 165, 0, 38],
    ]
)


def normalize_image(x: np.ndarray) -> np.ndarray:
    """Rescale to [0, 1]."""
    x = np.asarray(x, dtype=np.float32)
    ma, mi = float(x.max()), float(x.min())
    d = ma - mi if ma != mi else 1e-5
    return (x - mi) / d


def sec_to_hm_str(t: float) -> str:
    """10239 → '02h50m39s'."""
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return f"{t:02d}h{m:02d}m{s:02d}s"


def make_color_wheel() -> np.ndarray:
    """The Middlebury color wheel, (55, 3)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Flow → Middlebury color code."""
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)

    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = k0 + 1
    k1[k1 == ncols + 1] = 1
    f = fk - k0

    img = np.zeros(u.shape + (3,))
    for i in range(3):
        col0 = _WHEEL[k0 - 1, i] / 255
        col1 = _WHEEL[k1 - 1, i] / 255
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., i] = np.floor(255 * col * (1 - nan_idx))
    return img


def flow_to_image(flow: np.ndarray, max_rad: float | None = None) -> np.ndarray:
    """Flow map (H, W, ≥2) → Middlebury color image, uint8."""
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    if max_rad is None:
        max_rad = max(-1, float(np.sqrt(u**2 + v**2).max()))
    u = u / (max_rad + np.finfo(float).eps)
    v = v / (max_rad + np.finfo(float).eps)
    img = compute_color(u, v)
    img[unknown] = 0
    return np.uint8(img)


def get_flow_error_image(
    gt_flow_occ: np.ndarray,
    valid_flow_occ: np.ndarray,
    valid_flow_noc: np.ndarray,
    flow: np.ndarray,
) -> np.ndarray:
    """KITTI flow-error heatmap (H, W, 3) float: the error normalized by
    min(err/3, 20·err/|gt|), coloured by :data:`_LC`, halved outside the
    non-occluded mask and zero outside the valid mask."""
    h, w = flow.shape[:2]
    out = np.zeros((h, w, 3))
    df = gt_flow_occ[..., :2] - flow[..., :2]
    f_err = np.sqrt((df**2).sum(-1))
    f_mag = np.sqrt((gt_flow_occ[..., :2] ** 2).sum(-1)) + 1e-6
    n_err = np.minimum(f_err / 3.0, 20.0 * f_err / f_mag)
    for lo, hi, r, g, b in _LC:
        out[(lo <= n_err) & (n_err < hi)] = (r, g, b)
    out[~valid_flow_noc.astype(bool)] *= 0.5
    out[~valid_flow_occ.astype(bool)] = 0
    return out


def flow_read_png(fpath: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """KITTI 16-bit optical-flow PNG → (u, v, valid), read with cv2 (PIL
    cannot read 16-bit RGB PNGs) and turned from BGR back to RGB."""
    import cv2

    I = cv2.imread(fpath, cv2.IMREAD_UNCHANGED)
    if I is None:
        raise FileNotFoundError(fpath)
    I = I[:, :, ::-1].astype(np.int64)
    u = (I[:, :, 0].astype("float64") - 2**15) / 64.0
    v = (I[:, :, 1].astype("float64") - 2**15) / 64.0
    return u, v, I[:, :, 2]


def load_as_float(path: str) -> np.ndarray:
    """Read an image with PIL → float32."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img).astype(np.float32)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 image (H, W[, 3]) with PIL; the format follows the
    file name."""
    from PIL import Image

    Image.fromarray(np.asarray(img)).save(path)


def draw_boxes_rgb(
    image_u8: np.ndarray,
    boxes_xyxy: np.ndarray,
    colors: list[tuple[int, int, int]] | None = None,
    width: int = 2,
) -> np.ndarray:
    """Draw bounding boxes on an (H, W, 3) uint8 image."""
    img = image_u8.copy()
    h, w = img.shape[:2]
    for n, box in enumerate(np.asarray(boxes_xyxy, dtype=int)):
        x1, y1, x2, y2 = [int(c) for c in box]
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        color = colors[n] if colors else (255, 0, 0)
        for t in range(width):
            xa, xb = np.clip([x1 + t, x2 - t], 0, w - 1)
            ya, yb = np.clip([y1 + t, y2 - t], 0, h - 1)
            img[ya, xa:xb + 1] = color
            img[yb, xa:xb + 1] = color
            img[ya:yb + 1, xa] = color
            img[ya:yb + 1, xb] = color
    return img


def write_result(f, errs, err_names) -> None:
    """One line per error: its name, a colon, a tab and the value to 3
    decimals."""
    for err, name in zip(errs, err_names):
        f.writelines(f"{name}: \t {err:.3f} \n")
