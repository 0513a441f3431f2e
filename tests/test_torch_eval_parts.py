"""The eval CLIs' parts in the port against their JAX counterparts on seeded
numpy inputs: the metrics, the flow-error image, the result file, the eval
chunks, the eval normalization, the antialiased linear resize, each eval
dataset item by item, and the eval flags."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_kitti2015, make_odometry, make_raw_drive
from mdn_sfm_tpu import metrics as jm
from mdn_sfm_tpu import utils as ju
from mdn_sfm_tpu import viz as jv
from mdn_sfm_tpu.config import parse_eval_config as j_parse_eval_config
from mdn_sfm_tpu.data import augment as ja
from mdn_sfm_tpu.data import eval_datasets as jd
from mdn_sfm_tpu_torch import metrics as tm
from mdn_sfm_tpu_torch import utils as tu
from mdn_sfm_tpu_torch import viz as tv
from mdn_sfm_tpu_torch.config import parse_eval_config
from mdn_sfm_tpu_torch.data import augment as ta
from mdn_sfm_tpu_torch.data import eval_datasets as td
from mdn_sfm_tpu_torch.geometry import resize_linear
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

RESIZE_ATOL = 1e-5  # unit-scale inputs; the weights are JAX's, rounded as it rounds them


def _equal_nested(a, b):
    """Equal values, types aside (numpy against numpy, lists, dicts)."""
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _equal_nested(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_nested(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ----------------------------------------------------------------- metrics


@pytest.mark.parametrize("case", ["random", "no_positives", "all_positive"])
def test_quantitative_results_match_jax(case):
    rng = np.random.default_rng(0)
    gt = (rng.random((48, 96)) > 0.7).astype(np.float32)
    pred = {"random": (rng.random((48, 96)) > 0.6).astype(np.float32),
            "no_positives": np.zeros((48, 96), np.float32),
            "all_positive": np.ones((48, 96), np.float32)}[case]
    if case == "no_positives":
        gt = np.zeros_like(gt)  # precision, recall, F1 are 0/0 → nan
    ours, theirs = tm.get_quantitative_results(pred, gt), jm.get_quantitative_results(pred, gt)
    np.testing.assert_array_equal(ours, theirs)
    assert np.isnan(ours[1]) == (case == "no_positives")


def test_binary_image_matches_jax():
    x = np.random.default_rng(1).random((16, 24)).astype(np.float32)
    for t in (0.3, 0.5):
        np.testing.assert_array_equal(tm.binary_image(x, t), jm.binary_image(x, t))


def test_epe_matches_jax():
    rng = np.random.default_rng(2)
    gt, pred = rng.normal(size=(2, 48, 96, 3)) * 4
    mask = (rng.random((48, 96)) > 0.3).astype(np.float64)
    assert tm.compute_epe(gt, pred, mask) == jm.compute_epe(gt, pred, mask)


def test_pose_error_matches_jax():
    rng = np.random.default_rng(3)

    def poses():
        out = []
        for _ in range(3):
            q, _ = np.linalg.qr(np.eye(3) + 0.05 * rng.normal(size=(3, 3)))
            out.append(np.hstack([q * np.sign(np.linalg.det(q)), rng.normal(size=(3, 1))]))
        return np.stack(out)

    gt, pred = poses(), poses()
    assert tm.compute_pose_error(gt, pred) == jm.compute_pose_error(gt, pred)


# -------------------------------------------------------------- viz, utils


def test_flow_error_image_matches_jax():
    rng = np.random.default_rng(4)
    gt = rng.normal(size=(48, 96, 2)) * 10
    pred = gt + rng.normal(size=(48, 96, 2)) * rng.choice([0.1, 1.0, 10.0, 100.0], size=(48, 96, 1))
    occ, noc = rng.random((48, 96)) > 0.1, rng.random((48, 96)) > 0.3
    ours, theirs = tv.get_flow_error_image(gt, occ, noc, pred), jv.get_flow_error_image(gt, occ, noc, pred)
    np.testing.assert_array_equal(ours, theirs)
    assert len(np.unique(ours.reshape(-1, 3), axis=0)) >= 6  # several colour bands hit


def test_write_result_matches_jax():
    ours, theirs = io.StringIO(), io.StringIO()
    errs, names = np.array([1.23456, 0.5]), ["epe_all", "epe_noc"]
    tv.write_result(ours, errs, names)
    jv.write_result(theirs, errs, names)
    assert ours.getvalue() == theirs.getvalue() == "epe_all: \t 1.235 \nepe_noc: \t 0.500 \n"


def test_imwrite_reads_back(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (8, 12, 3), dtype=np.uint8)
    tv.imwrite(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(tv.load_as_float(str(tmp_path / "x.png")), img.astype(np.float32))


@pytest.mark.parametrize("n,bs", [(0, 8), (2, 8), (8, 8), (9, 4), (5, 1), (3, 0)])
def test_eval_chunks_match_jax(n, bs):
    assert list(tu.eval_chunks(n, bs)) == list(ju.eval_chunks(n, bs))


def test_eval_preprocess_matches_jax():
    u8 = np.random.default_rng(6).integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    ours = ta.eval_preprocess(torch.from_numpy(u8))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ja.eval_preprocess(jnp.asarray(u8))), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ resize


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("src,dst", [((48, 96), (32, 96)), ((32, 96), (48, 96)),
                                     ((375, 1242), (192, 640)), ((192, 640), (375, 1242))])
def test_resize_linear_matches_jax(src, dst, channels):
    """Growing and shrinking (JAX antialiases when it shrinks), 2-D and
    3-channel, at the fixture's and KITTI's sizes."""
    extra = (channels,) if channels else ()
    x = np.random.default_rng(sum(src + dst)).normal(size=src + extra).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst + extra, method="linear"))
    got = resize_linear(torch.from_numpy(x), dst + extra)
    assert got.dtype == torch.float32 and tuple(got.shape) == dst + extra
    np.testing.assert_allclose(got.numpy(), want, atol=RESIZE_ATOL)


def test_resize_linear_keeps_equal_axes_and_refuses_a_rank_change():
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(resize_linear(x, (3, 4)), x)
    with pytest.raises(ValueError):
        resize_linear(x, (3, 4, 1))


# ---------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_parts"))
    make_kitti2015(root, n=3, h=48, w=96)
    make_odometry(root, "09", n_frames=5)
    make_odometry(root, "10", n_frames=4)
    return root


@pytest.mark.parametrize("name", ["ValidationFlow", "ValidationMobileMask"])
def test_kitti2015_readers_match_jax(kitti, name):
    ours, theirs = getattr(td, name)(kitti, n=3), getattr(jd, name)(kitti, n=3)
    assert len(ours) == len(theirs) == 3
    for j in range(3):
        _equal_nested(ours[j], theirs[j])
    with pytest.raises(IndexError):
        ours[3]


def test_odometry_framework_matches_jax(kitti):
    root = os.path.join(kitti, "odometry_data")
    for seq_len in (3, 5):
        ours, theirs = td.OdometryFramework(root, ["09", "10"], seq_len), jd.OdometryFramework(root, ["09", "10"], seq_len)
        assert len(ours) == len(theirs) > 0
        for j in range(len(ours)):
            _equal_nested(ours[j], theirs[j])
        _equal_nested(list(ours), list(theirs))


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """make_raw_drive under <root>/raw_data, the layout the Eigen-val pairs
    are read from; one split line more whose next frame is missing."""
    root = str(tmp_path_factory.mktemp("raw_parts"))
    lines = make_raw_drive(os.path.join(root, "raw_data"), n_frames=5)
    return root, lines + ["2011_09_26/2011_09_26_drive_0001_sync 4 l"]


def test_mobile_mask_more_matches_jax(raw):
    root, lines = raw
    ours, theirs = td.ValidationMobileMaskMore(root, lines[:-1]), jd.ValidationMobileMaskMore(root, lines[:-1])
    assert len(ours) == len(theirs) == 3
    for j in range(3):
        _equal_nested(ours[j], theirs[j])


@pytest.mark.parametrize("choose", [2, 10])
def test_check_next_frame_matches_jax(raw, choose, capsys):
    root, lines = raw
    ours = td.check_next_frame(lines, root, choose=choose, seed=0)
    theirs = jd.check_next_frame(lines, root, choose=choose, seed=0)
    assert ours == theirs and len(ours) == min(choose, 3)
    assert lines[-1] not in ours
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and "delete 1 items" in out[0]


# ------------------------------------------------------------------- flags


@pytest.mark.parametrize("argv", [
    [],
    ["--data_root", "k", "--version", "v9", "--idx", "3", "--binary_threshold", "0.18", "--mode", "TG",
     "--height", "192", "--width", "640", "--eval_batch_size", "4", "--save_pred_masks", "--pred_errors",
     "--scales", "0", "1", "--compute_dtype", "float32", "--sequence_length", "5"],
])
def test_parse_eval_config_matches_jax(argv):
    assert json.loads(parse_eval_config(argv).to_json()) == json.loads(j_parse_eval_config(argv).to_json())
