"""The port's native C++ components against the JAX package's: the RLE
codec, mask bbox/union and NMS give identical results; the fused decode +
resize is bit-exact with PIL and within ±1 LSB of cv2; and the build is
race-free when several processes build the library at once."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from mdn_sfm_tpu import native as J
from mdn_sfm_tpu_torch import native as N

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prebuild_jax_rle() -> None:
    """Build the JAX package's git-ignored ``librle.so`` whole before its
    functions are called: to a temporary file, then ``os.replace``. Its own
    build writes the file in place, and other test workers may load it
    meanwhile; a complete file here leaves them nothing half-written."""
    so, src = J._SO, J._SRC
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return
    tmp = f"{so}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, so)


@pytest.fixture(autouse=True, scope="module")
def _jax_rle_built():
    prebuild_jax_rle()


@pytest.mark.parametrize("seed", range(4))
def test_rle_matches_jax_and_round_trips(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 90, 2)
    mask = (rng.random((h, w)) > 0.6).astype(np.uint8)
    ours = N.rle_encode(mask)
    assert ours == J.rle_encode(mask)
    assert np.array_equal(N.rle_decode(ours), mask)
    assert np.array_equal(N.rle_decode({"size": ours["size"], "counts": ours["counts"].decode()}), mask)


@pytest.mark.parametrize("fill", [0, 1])
def test_rle_empty_and_full(fill):
    mask = np.full((7, 9), fill, np.uint8)
    assert N.rle_encode(mask) == J.rle_encode(mask)
    assert np.array_equal(N.rle_decode(N.rle_encode(mask)), mask)


@pytest.mark.parametrize("density", [0.0, 0.97, 0.5])
def test_mask_bbox_matches_jax(density):
    rng = np.random.default_rng(3)
    mask = (rng.random((40, 60)) > density).astype(np.uint8) if density else np.zeros((40, 60), np.uint8)
    assert N.mask_bbox(mask) == J.mask_bbox(mask)


def test_mask_union_matches_jax():
    masks = (np.random.default_rng(1).random((4, 16, 16)) > 0.8).astype(np.uint8)
    assert np.array_equal(N.mask_union(masks), J.mask_union(masks))


@pytest.mark.parametrize("iou,max_keep", [(0.5, -1), (0.3, 3), (0.9, -1)])
def test_nms_matches_jax(iou, max_keep):
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 50, (30, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 20, (30, 2))], 1).astype(np.float32)
    scores = rng.random(30).astype(np.float32)
    np.testing.assert_array_equal(N.nms(boxes, scores, iou, max_keep), J.nms(boxes, scores, iou, max_keep))
    assert N.nms(np.zeros((0, 4), np.float32), np.zeros(0, np.float32), 0.5).shape == (0,)


def _png(tmp_path, arr, name="a.png"):
    from PIL import Image

    p = str(tmp_path / name)
    Image.fromarray(arr).save(p)
    return p


def test_png_decode_bit_exact_with_pil(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)
    out, (sw, sh) = N.decode_resize(_png(tmp_path, img), 37, 53)
    assert (sw, sh) == (53, 37) and np.array_equal(out, img)


def test_jpeg_decode_bit_exact_with_pil(tmp_path):
    from PIL import Image

    p = str(tmp_path / "a.jpg")
    Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 64, 3), np.uint8)).save(p, quality=92)
    out, _ = N.decode_resize(p, 40, 64)
    assert np.array_equal(out, np.asarray(Image.open(p).convert("RGB")))


@pytest.mark.parametrize("h,w", [(128, 416), (192, 640), (375, 1242)])
def test_resize_within_1_lsb_of_cv2(h, w):
    import cv2

    img = np.random.default_rng(3).integers(0, 256, (375, 1242, 3), np.uint8)
    assert np.abs(N.resize_bilinear_u8(img, h, w).astype(int) - cv2.resize(img, (w, h)).astype(int)).max() <= 1


def test_batch_matches_single_and_reports_errors(tmp_path):
    rng = np.random.default_rng(4)
    paths = [_png(tmp_path, rng.integers(0, 256, (24, 31, 3), np.uint8), f"{i}.png") for i in range(3)]
    arr, dims = N.decode_resize_batch(paths, 16, 20, n_threads=2)
    assert arr.shape == (3, 16, 20, 3) and dims.tolist() == [[31, 24]] * 3
    for i, p in enumerate(paths):
        assert np.array_equal(arr[i], N.decode_resize(p, 16, 20)[0])
    with pytest.raises(FileNotFoundError):
        N.decode_resize_batch([paths[0], str(tmp_path / "missing.png")], 8, 8)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image at all")
    with pytest.raises(ValueError):
        N.decode_resize(str(bad), 8, 8)


def test_libraries_are_named_by_source_hash():
    for name in ("rle", "imgio"):
        path = N.library_path(name)
        assert path.parent == N.BUILD_DIR and path.name.startswith(f"lib{name}-") and path.suffix == ".so"


PROCS = 6


def test_concurrent_builds_all_load(tmp_path):
    """Several processes build both libraries into one empty directory at
    the same moment: each must load a whole library and see imgio
    available, and no temporary file may be left behind."""
    build = tmp_path / "build"
    start = time.time() + 3.0
    code = (
        "import sys, time, pathlib\n"
        "from mdn_sfm_tpu_torch import native as N\n"
        f"N.BUILD_DIR = pathlib.Path({str(build)!r})\n"
        f"time.sleep(max(0.0, {start} - time.time()))\n"
        "assert N.imgio_available()\n"
        "assert N.mask_bbox([[0, 1], [0, 0]]) == [1, 0, 2, 1]\n"
        "print('ok', N.library_path('imgio').exists())\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(PROCS)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "ok True"
    names = sorted(os.listdir(build))
    assert not [n for n in names if n.endswith(".tmp")], names
    assert len([n for n in names if n.endswith(".so")]) == 2
