"""The port's ``evaluate_mix`` (the README table's metric path) against the
JAX CLI on one fixture world whose ``.pth`` weights both load: the batched
maps, the mean and sweep rows, batching, the panels and the README-table
harness; and the bf16 eval forward against the Flax bf16 forward."""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate_mix as jax_mix
from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Mode as JMode
from mdn_sfm_tpu.data.eval_datasets import KittiSegDataset as JKittiSegDataset
from mdn_sfm_tpu.geometry import scale_factor as j_scale_factor
from mdn_sfm_tpu.losses import epipolar_loss_terms as j_epipolar_loss_terms
from mdn_sfm_tpu_torch import evaluate_mix as M
from mdn_sfm_tpu_torch import reproduce_readme_table as rrt
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.data.eval_datasets import KittiSegDataset
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_eval_world import make_world
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

# f32 maps: the forward tolerance of tests/test_torch_parity.py
MAP_ATOL = 1e-4
# metric rows from binarizations that no pixel lies near (MARGIN): equal up
# to the mean's rounding
ROW_ATOL = 1e-6
MARGIN = 1e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory, "out_mix")


def _upsampled_predictions(cfg) -> np.ndarray:
    """Every sample's mobile map at its GT mask's resolution, as the port's
    evaluate_mix scores it, on the CPU."""
    models = T.load_eval_models(cfg, "cpu")
    dataset = KittiSegDataset(cfg.data_root, cfg.height, cfg.width, n=cfg.eval_num_samples)
    vals = []
    for j, _, mobile, _, _ in M.predict(cfg, models, dataset, torch.device("cpu")):
        vals.append(M.at_resolution(mobile, M.read_gt_mask(cfg.gt_mask_path, j).shape).ravel())
    return np.sort(np.concatenate(vals))


def _thresholds_with_margin(values: np.ndarray, k: int = 4) -> list[float]:
    """Midpoints of the k widest gaps between sorted prediction values that
    are wider than 2·MARGIN, so that no value lies within MARGIN of one."""
    gaps = np.diff(values)
    widest = [i for i in np.argsort(gaps)[::-1][:k] if gaps[i] > 2 * MARGIN]
    return sorted(round(float(values[i] + gaps[i] / 2), 6) for i in widest)


def test_eval_maps_match_jax(world):
    """mobile, post and ori of one batch against JAX's make_eval_forward +
    epipolar_loss_terms composed as the root evaluate_mix.py's step (f32)."""
    cfg, jcfg = world.cfg(), world.jax_cfg()
    items = [JKittiSegDataset(cfg.data_root, cfg.height, cfg.width, n=cfg.eval_num_samples)[j]
             for j in range(cfg.eval_num_samples)]
    tgt, ref, inv_K = (np.stack([x[k] for x in items]) for k in (("color", 0), ("color", 1), "inv_K"))

    fwd = JT.make_eval_forward(jcfg, JT.build_models(jcfg))
    flows, mobiles, _, _, cam = fwd(world.variables, tgt, ref)
    viz = dataclasses.replace(jcfg, mode=JMode.SN, w_d2_sim=0.0)
    _, post, ori = j_epipolar_loss_terms(viz, flows[0] * j_scale_factor(cfg.height, cfg.width), mobiles[0],
                                         jnp.asarray(inv_K), cam[:, :3, :3], cam[:, :3, 3], None, None)

    models = T.load_eval_models(cfg, "cpu")
    ours = M.eval_maps(cfg, models, *(torch.from_numpy(x) for x in (tgt, ref, inv_K)))
    for name, o, t in zip(("mobile", "post", "ori"), ours, (mobiles[0], post, ori)):
        assert o.shape == t.shape and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=MAP_ATOL, err_msg=name)


def test_evaluate_rows_match_jax(world):
    """The mean row and the sweep rows against JAX's evaluate(), at
    thresholds with no upsampled prediction pixel within MARGIN."""
    cfg = world.cfg()
    values = _upsampled_predictions(cfg)
    thresholds = _thresholds_with_margin(values)
    assert len(thresholds) >= 2, "the fixture's predictions leave no threshold with a margin"
    assert np.abs(values[:, None] - np.array(thresholds)[None]).min() > MARGIN

    ours, our_rows = M.evaluate(dataclasses.replace(cfg, binary_threshold=thresholds[0]), thresholds,
                                device="cpu")
    theirs, their_rows = jax_mix.evaluate(world.jax_cfg(binary_threshold=thresholds[0]), thresholds)
    assert ours.shape == (1, 5)
    np.testing.assert_allclose(ours, theirs, atol=ROW_ATOL)
    assert sorted(our_rows) == sorted(their_rows) == thresholds
    for t in thresholds:
        np.testing.assert_allclose(our_rows[t], their_rows[t], atol=ROW_ATOL, err_msg=str(t))
    # the thresholds binarize: some rows have positives
    assert any(np.isfinite(our_rows[t][0, 1]) for t in thresholds)


def test_no_positives_row_is_nan_like_jax(world):
    """A threshold above every prediction: precision and F1 are nan (0/0),
    as in the reference."""
    cfg = world.cfg(binary_threshold=0.999)
    ours = M.evaluate(cfg, device="cpu")
    theirs = jax_mix.evaluate(world.jax_cfg(binary_threshold=0.999))
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(theirs))
    assert np.isnan(ours[0, 1])
    np.testing.assert_allclose(ours, theirs, atol=ROW_ATOL)


def test_batch_8_equals_batch_1(world):
    cfg = world.cfg()
    thresholds = _thresholds_with_margin(_upsampled_predictions(cfg))
    cfg = dataclasses.replace(cfg, binary_threshold=thresholds[0])
    batched = M.evaluate(cfg, device="cpu")  # eval_batch_size 8, 2 samples: one padded batch
    single = M.evaluate(dataclasses.replace(cfg, eval_batch_size=1), device="cpu")
    np.testing.assert_allclose(single, batched, atol=ROW_ATOL)


def test_panels_written(world):
    cfg = world.cfg()
    M.evaluate(cfg, device="cpu")
    out = os.path.join(cfg.eval_out_dir, "mobile", f"masks_{cfg.version}_{cfg.idx}")
    from PIL import Image

    for j in range(cfg.eval_num_samples):
        with Image.open(os.path.join(out, f"{j}.png")) as im:
            assert im.size == (5 * cfg.width, cfg.height) and im.mode == "RGB"


def test_reproduce_readme_table_runs(world, capsys):
    cfg = world.cfg()
    argv = ["--data_root", cfg.data_root, "--log_dir", cfg.log_dir, "--gt_mask_path", cfg.gt_mask_path,
            "--frozen_folder", cfg.load_weights_folder, "--height", str(cfg.height), "--width", str(cfg.width),
            "--eval_out_dir", cfg.eval_out_dir, "--mode_versions", "SN=v1:0", "TG=v1:0",
            "--eval_num_samples", "2", "--sweep", "0.02", "--device", "cpu"]
    assert rrt.main(argv) == 0
    out = capsys.readouterr().out
    assert "| SN |" in out and "| TG |" in out and "Best-Dice operating point" in out
    # the published threshold is in the sweep: the best Dice is never worse
    headline = float(re.search(r"\| SN \|.*?\| ([\d.]+|nan) \(18.58\)", out).group(1))
    best = float(re.search(r"\| SN \| [\d.]+ \(0.18\) \| ([\d.]+|nan) ", out).group(1))
    assert np.isnan(headline) or best >= headline - 1e-9


# bf16 autocast against the Flax bf16 forward: both round the convolutions'
# inputs and outputs to bf16 (8 significand bits, 2^-8 = 3.9e-3 relative) but
# not at the same ops (autocast keeps batch norm and the elementwise ops in
# f32; Flax rounds the pose head's output to bf16), so 18 layers apart the
# outputs differ by a few bf16 steps of their scale. Largest difference over
# three seeded inputs on this world, relative to each output's largest
# magnitude: flow 1.75e-2, mobile 1.06e-2, axis-angle and translation
# 2.22e-2, cam_T_cam 4e-5 (its scale is the identity's 1). Held at 2× that;
# at f32 the same comparison is under 5e-6.
BF16_REL = {"flow": 3.5e-2, "mobile": 2.5e-2, "axisangle": 4.5e-2, "translation": 4.5e-2, "cam": 1e-4}


def test_bf16_eval_forward_matches_flax_bf16(world):
    cfg, jcfg = world.cfg(compute_dtype="bfloat16"), world.jax_cfg(compute_dtype="bfloat16")
    nets = T.build_models(cfg, device="cpu")
    for n, m in zip(("flownet", "posenet", "mobile_decoder"), nets):
        m.load_state_dict(state_dict_from_flax(n, world.variables[n]))
    nets.mobile.eval()
    rng = np.random.default_rng(0)
    tgt, ref = (rng.normal(size=(2, cfg.height, cfg.width, 3)).astype(np.float32) for _ in range(2))
    ours = T.eval_forward(cfg, nets, torch.from_numpy(tgt), torch.from_numpy(ref))
    theirs = jax.device_get(JT.make_eval_forward(jcfg, JT.build_models(jcfg))(world.variables, tgt, ref))

    def rel(o, t):
        t = np.asarray(t, np.float32)
        return float(np.abs(o.float().reshape(t.shape).numpy() - t).max() / np.abs(t).max())

    for s in cfg.scales:
        assert rel(ours[0][s], theirs[0][s]) <= BF16_REL["flow"], s
        assert rel(ours[1][s], theirs[1][s]) <= BF16_REL["mobile"], s
    for name, o, t in zip(("axisangle", "translation", "cam"), ours[2:], theirs[2:]):
        assert rel(o, t) <= BF16_REL[name], name
