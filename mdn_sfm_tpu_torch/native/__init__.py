"""Native C++ host components, loaded with ctypes — the port's own copy of
``mdn_sfm_tpu.native``: the COCO RLE codec, mask bbox/union and greedy NMS
(``rle.cpp``), and the fused PNG/JPEG decode + bilinear resize (``imgio.cpp``,
linked against the system libjpeg and libpng).

Each library is built with ``g++`` at first use into the git-ignored
``mdn_sfm_tpu_torch/_build/``, named by a hash of its source, its flags and
the shared libraries it links as this host's loader finds them (so a copy of
the tree on a host with other libraries builds its own). The build is safe
across processes: the compiler writes a temporary file that ``os.replace``
moves into place, under an ``fcntl`` lock on a file beside it. A process
that finds another one building waits on the lock and then loads the
finished library; it never sees a half-written one. ``imgio_available()`` is
False when compiling or linking ``imgio.cpp`` fails (no libjpeg/libpng
headers or libraries) or when the built library does not load.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = {"rle": (), "imgio": ("-ljpeg", "-lpng")}

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
_IMGIO_FAILED: list[str] = []  # the compiler's or the loader's message, once imgio failed


def library_path(name: str) -> Path:
    """Where ``<name>.cpp`` is built: ``_build/lib<name>-<hash>.so``, the hash
    of its source, its flags and the sonames of the libraries it links."""
    src = (_HERE / f"{name}.cpp").read_bytes()
    flags = " ".join(CXX_FLAGS + _LIBS[name]).encode()
    linked = " ".join(str(ctypes.util.find_library(flag[2:])) for flag in _LIBS[name]).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(src + flags + linked).hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless it is built; returns the library path.

    Race-free across processes: an exclusive ``fcntl`` lock on
    ``<library>.lock`` is held while checking and compiling, the compiler
    writes ``<library>.<pid>.tmp``, and ``os.replace`` publishes it whole.
    Raises ``subprocess.CalledProcessError`` when the compiler fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # waits while another process builds
        try:
            if out.exists():
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(
                    ["g++", *CXX_FLAGS, str(_HERE / f"{name}.cpp"), "-o", str(tmp), *_LIBS[name]],
                    check=True, capture_output=True, text=True,
                )
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _load(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = _declare(name, ctypes.CDLL(str(build(name))))
        return lib


def _declare(name: str, L: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if name == "rle":
        u32p = ctypes.POINTER(ctypes.c_uint32)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        L.rle_encode.restype = ctypes.c_int64
        L.rle_encode.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u32p]
        L.rle_decode.restype = None
        L.rle_decode.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p]
        L.rle_to_string.restype = ctypes.c_int64
        L.rle_to_string.argtypes = [u32p, ctypes.c_int64, ctypes.c_char_p]
        L.rle_from_string.restype = ctypes.c_int64
        L.rle_from_string.argtypes = [ctypes.c_char_p, ctypes.c_int64, u32p]
        L.mask_bbox.restype = None
        L.mask_bbox.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i32p]
        L.mask_union.restype = None
        L.mask_union.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p]
        L.nms.restype = ctypes.c_int64
        L.nms.argtypes = [f32p, i64p, ctypes.c_int64, ctypes.c_float, ctypes.c_int64, i64p]
    else:
        L.img_decode_resize.restype = ctypes.c_int32
        L.img_decode_resize.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64, ctypes.c_int64, i32p, i32p]
        L.img_decode_resize_batch.restype = ctypes.c_int32
        L.img_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, u8p,
            ctypes.c_int64, ctypes.c_int64, i32p, ctypes.c_int64, i32p,
        ]
        L.img_resize_bilinear.restype = None
        L.img_resize_bilinear.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u8p, ctypes.c_int64, ctypes.c_int64]
    return L


def lib() -> ctypes.CDLL:
    """The RLE / bbox / union / NMS library, built first if needed."""
    return _load("rle")


def _ptr(arr: np.ndarray, ctype=ctypes.c_uint8):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# ------------------------------------------------------------ masks and RLE


def rle_encode(mask: np.ndarray) -> dict:
    """Encode a binary (H, W) mask as a COCO RLE dict {'size': [H, W],
    'counts': bytes} (column-major runs, COCO's 6-bit string form)."""
    mask = np.asarray(mask)
    h, w = mask.shape
    fmask = np.ascontiguousarray((mask != 0).astype(np.uint8).T.reshape(-1))  # index = x*h + y
    counts = np.empty(h * w + 1, np.uint32)
    L = lib()
    m = L.rle_encode(_ptr(fmask), h, w, _ptr(counts, ctypes.c_uint32))
    out = ctypes.create_string_buffer(int(8 * m))
    n = L.rle_to_string(_ptr(counts, ctypes.c_uint32), m, out)
    return {"size": [int(h), int(w)], "counts": out.raw[:n]}


def rle_decode(rle: dict) -> np.ndarray:
    """Decode a COCO RLE dict back to a binary (H, W) uint8 mask."""
    h, w = rle["size"]
    s = rle["counts"]
    if isinstance(s, str):
        s = s.encode()
    counts = np.empty(len(s) + 1, np.uint32)
    L = lib()
    m = L.rle_from_string(s, len(s), _ptr(counts, ctypes.c_uint32))
    flat = np.empty(h * w, np.uint8)
    L.rle_decode(_ptr(counts, ctypes.c_uint32), m, h, w, _ptr(flat))
    return flat.reshape(w, h).T.copy()  # undo column-major


def mask_bbox(mask: np.ndarray) -> list[int] | None:
    """[xmin, ymin, xmax, ymax] of the nonzero pixels (exclusive max), or
    None for an empty mask."""
    mask = np.ascontiguousarray((np.asarray(mask) != 0).astype(np.uint8))
    h, w = mask.shape
    bbox = np.empty(4, np.int32)
    lib().mask_bbox(_ptr(mask), h, w, _ptr(bbox, ctypes.c_int32))
    if bbox[2] < 0:
        return None
    return [int(v) for v in bbox]


def mask_union(masks: np.ndarray) -> np.ndarray:
    """Union of (N, H, W) binary masks → (H, W) uint8."""
    masks = np.ascontiguousarray((np.asarray(masks) != 0).astype(np.uint8))
    n, h, w = masks.shape
    out = np.empty(h * w, np.uint8)
    lib().mask_union(_ptr(masks.reshape(-1)), n, h * w, _ptr(out))
    return out.reshape(h, w)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float, max_keep: int = -1) -> np.ndarray:
    """Greedy IoU NMS on the host: the kept indices, by falling score.

    Args:
        boxes: (N, 4) XYXY float32.
        scores: (N,) float32.
    """
    boxes = np.ascontiguousarray(boxes, np.float32)
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    order = np.ascontiguousarray(np.argsort(-np.asarray(scores)), np.int64)
    keep = np.empty(n, np.int64)
    kept = lib().nms(_ptr(boxes, ctypes.c_float), _ptr(order, ctypes.c_int64), n, float(iou_threshold),
                     n if max_keep < 0 else max_keep, _ptr(keep, ctypes.c_int64))
    return keep[:kept].copy()


# ----------------------------------------------------------------- image IO


def _imgio() -> ctypes.CDLL | None:
    """The decode library, or None when it cannot be compiled, linked or
    loaded (``ctypes.CDLL`` raises ``OSError`` for a library whose
    dependencies this host lacks)."""
    if _IMGIO_FAILED:
        return None
    try:
        return _load("imgio")
    except subprocess.CalledProcessError as e:
        _IMGIO_FAILED.append(e.stderr or str(e))
    except OSError as e:
        _IMGIO_FAILED.append(str(e))
    return None


def imgio_available() -> bool:
    """True if the native decode library compiles, links and loads."""
    return _imgio() is not None


def _need_imgio() -> ctypes.CDLL:
    L = _imgio()
    if L is None:
        raise RuntimeError(f"native imgio is unavailable (no libjpeg/libpng?): {_IMGIO_FAILED[0]}")
    return L


def decode_resize(path: str, height: int, width: int) -> tuple[np.ndarray, tuple[int, int]]:
    """Decode a PNG/JPEG and bilinear-resize it to (height, width) RGB u8.

    Returns (image (H, W, 3) u8, (src_w, src_h)). Raises FileNotFoundError
    or ValueError on unreadable or non-PNG/JPEG input."""
    L = _need_imgio()
    out = np.empty((height, width, 3), np.uint8)
    sw, sh = ctypes.c_int32(0), ctypes.c_int32(0)
    rc = L.img_decode_resize(path.encode(), _ptr(out), height, width, ctypes.byref(sw), ctypes.byref(sh))
    if rc == 1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"decode failed for {path} (code {rc})")
    return out, (int(sw.value), int(sh.value))


def decode_resize_batch(
    paths: list[str], height: int, width: int, n_threads: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """Threaded decode + resize → ((N, H, W, 3) u8, (N, 2) source (w, h)).
    Raises on the first file that fails."""
    L = _need_imgio()
    n = len(paths)
    out = np.empty((n, height, width, 3), np.uint8)
    dims = np.zeros((n, 2), np.int32)
    errs = np.zeros(n, np.int32)
    cpaths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fails = L.img_decode_resize_batch(cpaths, n, _ptr(out.reshape(-1)), height, width,
                                      _ptr(dims, ctypes.c_int32), n_threads, _ptr(errs, ctypes.c_int32))
    if fails:
        bad = int(np.flatnonzero(errs)[0])
        if errs[bad] == 1:
            raise FileNotFoundError(paths[bad])
        raise ValueError(f"decode failed for {paths[bad]} (code {int(errs[bad])})")
    return out, dims


def resize_bilinear_u8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Separable bilinear resize of an (H, W, 3) u8 image (cv2's sampling
    grid; within ±1 LSB of cv2's fixed point)."""
    L = _need_imgio()
    img = np.ascontiguousarray(img, np.uint8)
    sh, sw = img.shape[:2]
    out = np.empty((height, width, 3), np.uint8)
    L.img_resize_bilinear(_ptr(img.reshape(-1)), sh, sw, _ptr(out.reshape(-1)), height, width)
    return out
