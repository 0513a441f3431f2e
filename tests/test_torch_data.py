"""The port's host data path against the JAX package's: split manifests and
host sharding, the shuffling loader, the KITTI raw reader, the decoded cache,
synthetic items, the inline-validation set and the host helpers its logging
uses. Host code on both sides, so equality is exact unless a test states a
tolerance."""

import os

import numpy as np
import pytest

from fixtures import make_kitti2015, make_raw_drive
from mdn_sfm_tpu import labels as JL
from mdn_sfm_tpu import metrics as JM
from mdn_sfm_tpu import viz as JV
from mdn_sfm_tpu.data import cache as jcache
from mdn_sfm_tpu.data import kitti as jkitti
from mdn_sfm_tpu.data import loader as jloader
from mdn_sfm_tpu.data import splits as jsplits
from mdn_sfm_tpu.data import synthetic as jsynth
from mdn_sfm_tpu_torch import labels as TL
from mdn_sfm_tpu_torch import metrics as TM
from mdn_sfm_tpu_torch import viz as TV
from mdn_sfm_tpu_torch.data import cache as tcache
from mdn_sfm_tpu_torch.data import kitti as tkitti
from mdn_sfm_tpu_torch.data import loader as tloader
from mdn_sfm_tpu_torch.data import splits as tsplits
from mdn_sfm_tpu_torch.data import synthetic as tsynth
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- splits


@pytest.fixture(scope="module", params=["train", "val"])
def manifest(request):
    path = tsplits.split_path(tsplits.repo_root(), "eigen_zhou", request.param)
    assert path == jsplits.split_path(REPO, "eigen_zhou", request.param) and path.endswith(".gz")
    return path


def test_read_split_lines_and_keys_match_jax(manifest):
    ours, theirs = tsplits.read_split_lines(manifest), jsplits.read_split_lines(manifest)
    assert len(ours) > 4000 and [tuple(l) for l in ours] == [tuple(l) for l in theirs]
    assert [tsplits.sample_key(l) for l in ours] == [jsplits.sample_key(l) for l in theirs]


@pytest.mark.parametrize("host_id,host_count", [(0, 1), (1, 3), (3, 4)])
def test_shard_for_host_matches_jax(manifest, host_id, host_count):
    lines = tsplits.read_split_lines(manifest)
    ours = tsplits.shard_for_host(lines, host_id, host_count)
    assert [tuple(l) for l in ours] == [tuple(l) for l in jsplits.shard_for_host(lines, host_id, host_count)]


def test_sample_key_canonicalizes_side_aliases():
    for side, canon in (("2", "l"), ("3", "r"), ("l", "l")):
        line = tsplits.SplitLine("2011_09_26/drive_0001_sync", 7, side)
        assert tsplits.sample_key(line) == jsplits.sample_key(jsplits.SplitLine(*line))
        assert tsplits.sample_key(line).endswith(f"_7_{canon}")


# ---------------------------------------------------------------- loader


class _Indexed:
    """Items that carry their own index, so the batches show the order."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.int64), np.asarray([i * 10], np.float32)


def _sequence(loader_cls, n, bs, epochs, skip=0, workers=3):
    loader = loader_cls(_Indexed(n), bs, shuffle=True, seed=7, num_workers=workers)
    out = []
    for e in range(epochs):
        loader.epoch = e
        for arrays, idxs in loader.iter_batches(skip if e == 0 else 0):
            assert np.array_equal(arrays[0][:, 0], idxs)
            out.append(list(map(int, idxs)))
    return out


@pytest.mark.parametrize("n,bs,skip", [(23, 4, 0), (23, 4, 3), (16, 2, 7)])
def test_host_loader_order_matches_jax(n, bs, skip):
    ours = _sequence(tloader.HostLoader, n, bs, epochs=2, skip=skip)
    assert ours == _sequence(jloader.HostLoader, n, bs, epochs=2, skip=skip)
    assert len(ours) == 2 * (n // bs) - skip


def test_host_loader_raises_a_failed_item():
    class Broken(_Indexed):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable")
            return super().__getitem__(i)

    loader = tloader.HostLoader(Broken(8), 2, shuffle=False, num_workers=2)
    with pytest.raises(OSError, match="unreadable"):
        list(loader)


def test_subset():
    sub = tloader.Subset(_Indexed(10), [3, 1])
    assert len(sub) == 2 and int(sub[0][0][0]) == 3 and int(sub[1][0][0]) == 1


# ---------------------------------------------------------- KITTI reader


@pytest.fixture(scope="module")
def raw_drive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    return root, [tsplits.SplitLine.parse(s) for s in make_raw_drive(root, h=48, w=96)]


@pytest.mark.parametrize("size", [(48, 96), (32, 64)])
def test_kitti_reader_pil_route_bit_exact_with_jax(raw_drive, size):
    root, lines = raw_drive
    ours = tkitti.KittiRawDataset(root, lines, *size, use_native=False)
    theirs = jkitti.KittiRawDataset(root, [jsplits.SplitLine(*l) for l in lines], *size, use_native=False)
    assert len(ours) == len(theirs) == 2
    for i in range(len(ours)):
        (c, k), (jc, jk) = ours[i], theirs[i]
        assert c.dtype == np.uint8 and c.shape == (3, *size, 3)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(k, jk)


@pytest.mark.parametrize("size,lsb", [((48, 96), 0), ((32, 64), 1)])
def test_kitti_reader_native_route_within_1_lsb_of_jax(raw_drive, size, lsb):
    """The native decode is bit-exact; its resize is within ±1 LSB of cv2's
    fixed point (exact at the identity size)."""
    root, lines = raw_drive
    ours = tkitti.KittiRawDataset(root, lines, *size, use_native=True)
    theirs = jkitti.KittiRawDataset(root, [jsplits.SplitLine(*l) for l in lines], *size, use_native=False)
    for i in range(len(ours)):
        (c, k), (jc, jk) = ours[i], theirs[i]
        assert np.abs(c.astype(int) - jc.astype(int)).max() <= lsb
        np.testing.assert_array_equal(k, jk)


def test_kitti_reader_defaults_to_native_and_keys(raw_drive):
    root, lines = raw_drive
    ds = tkitti.KittiRawDataset(root, lines, 32, 64)
    assert ds.use_native
    jds = jkitti.KittiRawDataset(root, [jsplits.SplitLine(*l) for l in lines], 32, 64, use_native=False)
    assert ds.cache_key() == jds.cache_key()
    np.testing.assert_array_equal(
        tkitti.parse_calib_intrinsics(os.path.join(root, "2011_09_26", "calib_cam_to_cam.txt"), 3),
        jkitti.parse_calib_intrinsics(os.path.join(root, "2011_09_26", "calib_cam_to_cam.txt"), 3))


def test_kitti_reader_without_any_decoder_raises(raw_drive, monkeypatch):
    root, lines = raw_drive
    monkeypatch.setattr(tkitti, "_pil_available", lambda: False)
    with pytest.raises(RuntimeError, match="no image decoder"):
        tkitti.KittiRawDataset(root, lines, 32, 64, use_native=False)


def test_decoded_cache_round_trips(raw_drive, tmp_path):
    root, lines = raw_drive
    ds = tkitti.KittiRawDataset(root, lines, 32, 64, use_native=False)
    cache = tcache.DecodedCache(ds, str(tmp_path))
    assert cache.hit_fraction == 0.5  # the probe item is stored at once
    first = [cache[i] for i in range(len(cache))]
    assert cache.hit_fraction == 1.0
    reopened = tcache.DecodedCache(ds, str(tmp_path))
    assert reopened.path == cache.path and reopened.hit_fraction == 1.0
    for i, item in enumerate(first):
        for a, b, c in zip(item, reopened[i], ds[i]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    # the JAX cache names the same dataset with the same fingerprint
    jds = jkitti.KittiRawDataset(root, [jsplits.SplitLine(*l) for l in lines], 32, 64, use_native=False)
    assert os.path.basename(jcache.DecodedCache(jds, str(tmp_path / "j")).path) == os.path.basename(cache.path)
    assert reopened.lines == ds.lines  # attributes pass through


@pytest.mark.parametrize("index", [0, 5])
def test_synthetic_dataset_items_match_jax(index):
    ours, theirs = tsynth.SyntheticDataset(8, 32, 64)[index], jsynth.SyntheticDataset(8, 32, 64)[index]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert len(tsynth.SyntheticDataset(8, 32, 64)) == 8


# ----------------------------------------------------- inline-val data


@pytest.fixture(scope="module")
def kitti2015(tmp_path_factory):
    from test_torch_native import prebuild_jax_rle

    prebuild_jax_rle()  # the JAX KittiSegDataset calls its native mask_bbox/rle_encode
    root = str(tmp_path_factory.mktemp("k15"))
    make_kitti2015(root, n=2)
    return root


@pytest.mark.parametrize("index", [0, 1])
def test_kitti_seg_dataset_matches_jax(kitti2015, index):
    from mdn_sfm_tpu.data.eval_datasets import KittiSegDataset as JSeg
    from mdn_sfm_tpu_torch.data.eval_datasets import KittiSegDataset as TSeg

    ours, theirs = TSeg(kitti2015, 32, 64, n=2)[index], JSeg(kitti2015, 32, 64, n=2)[index]
    assert set(ours) == set(theirs)
    for k in (("color", 0), ("color", 1), "K", "instance_img"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=str(k))
    # inv_K: the port's closed-form inverse against the JAX one, f32
    np.testing.assert_allclose(ours["inv_K"], theirs["inv_K"], rtol=1e-6, atol=1e-7)
    assert len(ours["annotations"]) == len(theirs["annotations"]) == 1
    for a, b in zip(ours["annotations"], theirs["annotations"]):
        assert a == b


def test_prepare_pair_and_intrinsics_match_jax(kitti2015):
    from mdn_sfm_tpu.data import eval_datasets as JE
    from mdn_sfm_tpu_torch.data import eval_datasets as TE

    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 256, (48, 96, 3)).astype(np.float32), rng.integers(0, 256, (48, 96, 3), np.uint8)
    for x, y in zip(TE.prepare_pair(a, b, 32, 64), JE.prepare_pair(a, b, 32, 64)):
        np.testing.assert_array_equal(x, y)
    calib = os.path.join(kitti2015, "data_scene_flow_calib", "training", "calib_cam_to_cam", "000000.txt")
    np.testing.assert_array_equal(TE.get_intrinsics(calib, 3), JE.get_intrinsics(calib, 3))


# ------------------------------------------------------ host helpers


def test_flow_to_image_matches_jax():
    rng = np.random.default_rng(1)
    flow = rng.normal(scale=4.0, size=(16, 24, 2)).astype(np.float32)
    flow[0, 0] = 1e8  # unknown flow
    np.testing.assert_array_equal(TV.flow_to_image(flow), JV.flow_to_image(flow))
    np.testing.assert_array_equal(TV.flow_to_image(flow, max_rad=3.0), JV.flow_to_image(flow, max_rad=3.0))


@pytest.mark.parametrize("x", [np.arange(12.0).reshape(3, 4), np.full((2, 2), 3.0)])
def test_normalize_image_matches_jax(x):
    np.testing.assert_array_equal(TV.normalize_image(x), JV.normalize_image(x))


@pytest.mark.parametrize("t", [0, 59, 10239, 400000])
def test_sec_to_hm_str_matches_jax(t):
    assert TV.sec_to_hm_str(t) == JV.sec_to_hm_str(t)


def test_draw_boxes_matches_jax():
    img = np.zeros((20, 30, 3), np.uint8)
    boxes = np.array([[2, 3, 10, 12], [-5, 0, 40, 19]], np.float32)
    np.testing.assert_array_equal(TV.draw_boxes_rgb(img, boxes), JV.draw_boxes_rgb(img, boxes))
    np.testing.assert_array_equal(TV.draw_boxes_rgb(img, boxes, [(1, 2, 3), (4, 5, 6)], 1),
                                  JV.draw_boxes_rgb(img, boxes, [(1, 2, 3), (4, 5, 6)], 1))


def test_flow_read_png_and_load_as_float_match_jax(kitti2015):
    p = os.path.join(kitti2015, "data_scene_flow", "training", "flow_occ", "000000_10.png")
    for a, b in zip(TV.flow_read_png(p), JV.flow_read_png(p)):
        np.testing.assert_array_equal(a, b)
    img = os.path.join(kitti2015, "data_scene_flow", "training", "image_2", "000000_10.png")
    np.testing.assert_array_equal(TV.load_as_float(img), JV.load_as_float(img))


def test_load_as_float_without_imageio_reads_the_same_pixels(kitti2015, monkeypatch):
    """The port reads with PIL alone: with imageio unimportable (as on a
    machine that lacks it) it reads the KITTI-2015 PNGs to the array the
    JAX package's imageio reader gives."""
    import sys

    img = os.path.join(kitti2015, "data_scene_flow", "training", "image_2", "000001_11.png")
    want = JV.load_as_float(img)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    got = TV.load_as_float(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_kitti_decode_and_binary_image_match_jax():
    for v in [0, 26 * 256 + 1, 24 * 256, 7 * 256 + 3, 40 * 256, 5 * 256]:
        assert TL.kitti_decode(v) == JL.kitti_decode(v), v
    x = np.linspace(0, 1, 11, dtype=np.float32)
    np.testing.assert_array_equal(TM.binary_image(x, 0.4), JM.binary_image(x, 0.4))
    np.testing.assert_array_equal(TM.binary_image(np.arange(3), 1), JM.binary_image(np.arange(3), 1))
