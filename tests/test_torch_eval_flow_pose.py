"""The port's ``evaluate_flow``, ``evaluate_pose`` and ``evaluate_mask``
against the JAX CLIs on one fixture world whose ``.pth`` weights both load,
and every eval CLI's refusal to run on a missing card."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate_flow as jax_flow
import evaluate_mask as jax_mask
import evaluate_pose as jax_pose
import mdn_sfm_tpu.metrics as jax_metrics
from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.data.eval_datasets import ValidationFlow as JValidationFlow
from mdn_sfm_tpu.data.eval_datasets import ValidationMobileMask as JValidationMobileMask
from mdn_sfm_tpu.data.eval_datasets import prepare_pair as j_prepare_pair
from mdn_sfm_tpu.geometry import epipolar_residual as j_epipolar_residual
from mdn_sfm_tpu.geometry import gauss_distance_weight as j_gauss_distance_weight
from mdn_sfm_tpu.geometry import scale_factor as j_scale_factor
from mdn_sfm_tpu_torch import evaluate_flow as F
from mdn_sfm_tpu_torch import evaluate_mask as K
from mdn_sfm_tpu_torch import evaluate_mix, evaluate_pose, reproduce_readme_table
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.geometry import gauss_distance_weight
from mdn_sfm_tpu_torch.viz import load_as_float
from torch_eval_world import make_world, with_out_dir
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

EPE_RTOL = 1e-4  # EPE from the resized flows; result.txt prints 3 decimals
MAP_ATOL = 1e-4  # the normalized maps (each max 1), f32
POSE_ATOL = 1e-5  # ATE/RE and the chained poses, f32 nets, f64 chaining
PROB_MARGIN = 1e-3  # evaluate_mask's binary panel may differ only this near 0.5


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory, "out_flow_pose")


def _two_runs(world, tmp_path):
    """The world with a separate output folder for each package."""
    return with_out_dir(world, str(tmp_path / "port")), with_out_dir(world, str(tmp_path / "jax"))


def test_flow_epe_and_result_match_jax(world, tmp_path, monkeypatch):
    ours_w, theirs_w = _two_runs(world, tmp_path)
    epes = {"port": [], "jax": []}

    def recording(key, fn):
        def wrapped(*a):
            epes[key].append(fn(*a))
            return epes[key][-1]
        return wrapped

    monkeypatch.setattr(F, "compute_epe", recording("port", F.compute_epe))
    monkeypatch.setattr(jax_metrics, "compute_epe", recording("jax", jax_metrics.compute_epe))
    mean = F.evaluate(ours_w.cfg(), device="cpu")
    jax_flow.evaluate(theirs_w.jax_cfg())
    assert len(epes["port"]) == len(epes["jax"]) == 2 * world.kw["eval_num_samples"]  # occ and noc
    np.testing.assert_allclose(epes["port"], epes["jax"], rtol=EPE_RTOL)
    np.testing.assert_allclose(mean, np.reshape(epes["jax"], (-1, 2)).mean(0), rtol=EPE_RTOL)

    def result(w):
        with open(os.path.join(w.kw["eval_out_dir"], "flow", "mobile_masks", "result.txt")) as f:
            return [ln.split(":") for ln in f.read().splitlines()]

    ours, theirs = result(ours_w), result(theirs_w)
    assert [n for n, _ in ours] == [n for n, _ in theirs] == ["epe_all", "epe_noc"]
    np.testing.assert_allclose([float(v) for _, v in ours], [float(v) for _, v in theirs], rtol=EPE_RTOL, atol=1e-3)
    for j in range(world.kw["eval_num_samples"]):
        assert os.path.exists(os.path.join(ours_w.kw["eval_out_dir"], "flow", "mobile_masks", f"{j}.png"))


def test_flow_maps_match_jax(world):
    """The batch's pixel flow and its three normalized maps against JAX's
    eval forward + geometry.epipolar_residual composed as the root
    evaluate_flow.py's step, on the same inputs (f32)."""
    cfg, jcfg = world.cfg(), world.jax_cfg()
    H, W = cfg.height, cfg.width
    dataset = JValidationFlow(cfg.raw_dataset_dir, n=cfg.eval_num_samples)
    inv_Ks, gt_smalls, tgts, refs, Ms = [], [], [], [], []
    for j in range(cfg.eval_num_samples):
        s = dataset[j]
        h, w = s["tgt"].shape[:2]
        K = np.eye(4, dtype=np.float32)
        K[:3, :3] = s["intrinsics"] * np.array([[W / w], [H / h], [1.0]], np.float32)
        inv_Ks.append(np.linalg.inv(K)[:3, :3])
        gt = np.array(jax.image.resize(jnp.asarray(s["gt_flow_occ"][..., :2]), (H, W, 2), method="linear"))
        gt_smalls.append(gt * np.array([W / w, H / h], np.float32))
        t, r = j_prepare_pair(s["tgt"], s["next_tgt"], H, W)
        tgts.append(t[0])
        refs.append(r[0])
        Ms.append(s["gt_transformation"])
    tgt, ref, inv_K, gt_small, M = map(np.stack, (tgts, refs, inv_Ks, gt_smalls, Ms))
    # the fixture's GT flow is (2, 0) px everywhere, along the stereo
    # baseline's epipolar lines, so its map would be 0: add seeded noise
    gt_small = gt_small + np.random.default_rng(0).normal(size=gt_small.shape).astype(np.float32)

    flows, _, _, _, cam = JT.make_eval_forward(jcfg, JT.build_models(jcfg))(world.variables, tgt, ref)
    full = flows[0] * j_scale_factor(H, W)

    def nmax(x):
        return jnp.maximum(x.max(axis=tuple(range(1, x.ndim)), keepdims=True), 1e-12)

    epip = jnp.abs(j_epipolar_residual(full, inv_K, cam[:, :3, :3], cam[:, :3, 3]))
    post = (epip / jnp.asarray(j_gauss_distance_weight(H, W, 1, cfg.gauss_sigma1, cfg.gauss_sigma2)[0])[None]) ** 2
    gt_epip = jnp.abs(j_epipolar_residual(gt_small, inv_K, M[:, :3, :3], M[:, :3, 3]))
    theirs = (full, epip / nmax(epip), post / nmax(post), gt_epip / nmax(gt_epip))

    models = T.load_eval_models(cfg, "cpu", nets=("flownet", "posenet"))
    gauss = gauss_distance_weight(H, W, 1, cfg.gauss_sigma1, cfg.gauss_sigma2, "cpu")[0]
    ours = F.flow_maps(cfg, models, *(torch.from_numpy(x) for x in (tgt, ref, inv_K, gt_small, M)), gauss)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), rtol=1e-4, atol=1e-4, err_msg="flow")
    for name, o, t in zip(("epip_n", "post_epip", "gt_epip"), ours[1:], theirs[1:]):
        assert float(o.amax()) == pytest.approx(1.0), name
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=MAP_ATOL, err_msg=name)


def test_pose_matches_jax(world, tmp_path):
    ours_w, theirs_w = _two_runs(world, tmp_path)
    ours = evaluate_pose.evaluate(ours_w.cfg(), device="cpu")
    theirs = jax_pose.evaluate(theirs_w.jax_cfg())
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o, t, atol=POSE_ATOL)
    assert np.isfinite(ours[0]).all()
    poses = [np.load(os.path.join(w.kw["eval_out_dir"], "pose", "poses.npy")) for w in (ours_w, theirs_w)]
    # 3 snippets from seq 09 (5 frames) + 2 from seq 10 (4 frames)
    assert poses[0].shape == poses[1].shape == (5, world.kw["sequence_length"], 3, 4)
    np.testing.assert_allclose(poses[0], poses[1], atol=POSE_ATOL)


def test_mask_panels_match_jax(world):
    """The image panel equal; the probability panel (255·p truncated to
    uint8) within 1 of JAX's, as p agrees to 1e-4; the binary panel equal
    except where p lies within PROB_MARGIN of 0.5."""
    cfg = world.cfg(eval_name="port_masks")
    K.evaluate(cfg, device="cpu")
    jax_mask.evaluate(world.jax_cfg(eval_name="jax_masks"))
    base = os.path.join(cfg.log_dir, cfg.version, "models", f"weights_{cfg.idx}", "predictions", "mobile")

    models = T.load_eval_models(cfg, "cpu")
    frames = JValidationMobileMask(cfg.raw_dataset_dir, n=cfg.eval_num_samples)
    H = cfg.height
    for j in range(cfg.eval_num_samples):
        ours, theirs = (load_as_float(os.path.join(base, name, f"{j}.png")) for name in ("port_masks", "jax_masks"))
        assert ours.shape == theirs.shape == (3 * H, cfg.width, 3)
        tgt, ref = (torch.from_numpy(x) for x in j_prepare_pair(*frames[j], H, cfg.width))
        p = T.eval_forward(cfg, models, tgt, ref)[1][0][0, ..., 0].numpy()
        np.testing.assert_array_equal(ours[:H], theirs[:H])
        assert np.abs(ours[H:2 * H] - theirs[H:2 * H]).max() <= 1
        near = np.repeat((np.abs(p - 0.5) < PROB_MARGIN)[..., None], 3, -1)
        np.testing.assert_array_equal(np.where(near, 0, ours[2 * H:]), np.where(near, 0, theirs[2 * H:]))


@pytest.mark.parametrize("cli", [evaluate_mix, K, F, evaluate_pose, reproduce_readme_table])
def test_cli_refuses_cuda_without_a_card(world, cli):
    """``--device cuda`` without a card raises; nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    argv = ["--device", "cuda"]
    if cli is reproduce_readme_table:
        argv += ["--mode_versions", "SN=v1:0", "--data_root", world.kw["data_root"],
                 "--log_dir", world.kw["log_dir"], "--frozen_folder", world.kw["load_weights_folder"]]
    else:
        argv += ["--data_root", world.kw["data_root"], "--raw_dataset_dir", world.kw["raw_dataset_dir"]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)

