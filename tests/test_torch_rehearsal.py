"""The synthetic two-stage rehearsal: ``mdn_sfm_tpu_torch.synthetic_e2e``
against ``tools/synthetic_e2e.py`` and the JAX package.

The world's bytes, the pose oracle, the calibration's quantiles and one
phase-2 step per mode (float32, the same carried weights and world batch)
against JAX; the crafted brightness detector against the JAX fixture; phase
1 cutting the flow EPE by 30 % (the bar of ``tests/test_synthetic_e2e.py``);
and the CLI end to end at tiny budgets with the JAX tool's JSON keys."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.data.synthetic import moving_object_batch as j_world
from mdn_sfm_tpu_torch import synthetic_e2e as E
from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.data.synthetic import moving_object_batch
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (module-scoped fixture)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, B = 32, 64, 2
# the round-5 world (PARITY.md), at the tests' size
WORLD = dict(bright_object=True, obj_shift=6, obj_size=8)
MODES = ("SN", "T", "TG", "DS", "DC")
# the calibration's per-image quantiles from f32 nets: an order statistic
# moves by at most the maps' largest elementwise difference
QUANTILE_ATOL = 1e-5
# one step from equal params, f32: tests/test_torch_train_step.py's step-0
# bound
STEP_RTOL = 1e-5


# the CLI's subprocesses take one thread, as the test workers do
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")


def _args(**kw):
    return E.build_parser().parse_args(
        ["--device", "cpu", "--height", str(H), "--width", str(W), "--batch_size", str(B)]
        + [f"--{k}={v}" for k, v in kw.items()])


def _jax_cfg(cfg, tmp_path) -> JConfig:
    """The same options in the JAX package's Config (through opt.json)."""
    path = str(tmp_path / f"opt_{cfg.mode.value}.json")
    cfg.save(path)
    return JConfig.load(path)


@pytest.fixture(scope="module")
def jax_variables():
    """JAX's initial variables of the three nets, the pose oracle applied
    (the JAX tool's ``pose_oracle_variables``), and the port's models
    carrying them in float32."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from synthetic_e2e import pose_oracle_variables

    cfg = E.phase1_config(_args())
    jcfg = JConfig(height=H, width=W, compute_dtype="float32")
    models = JT.build_models(jcfg)
    init = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
    oracle = jax.device_get(pose_oracle_variables(init))
    tmodels = TT.build_models(cfg, device="cpu")
    for net, module in TT.modules_by_name(tmodels).items():
        module.load_state_dict(state_dict_from_flax(net, init[net]), strict=True)
    return cfg, jcfg, models, oracle, tmodels


@pytest.mark.parametrize("kw", [dict(), WORLD, dict(WORLD, obj_shift=3, bg_shift=1, num_frames=3)])
def test_world_bytes_equal_jax(kw):
    for a, b in zip(moving_object_batch(3, H, W, seed=11, **kw), j_world(3, H, W, seed=11, **kw)):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b


def test_pose_oracle_matches_jax(jax_variables):
    """The oracle's head and its output: axisangle 0, translation (1, 0, 0)
    on any input."""
    cfg, _, _, oracle, tmodels = jax_variables
    E.pose_oracle(tmodels)
    want = state_dict_from_flax("posenet", oracle["posenet"])
    for k, v in tmodels.pose.state_dict().items():
        assert torch.equal(v, want[k]), k
    x = torch.rand(3, 3, H, W, generator=torch.Generator().manual_seed(0))
    aa, t = tmodels.pose(x, x.flip(0))
    assert float(aa.abs().max()) == 0.0
    np.testing.assert_allclose(t.detach().reshape(3, 3).numpy(), [[1.0, 0.0, 0.0]] * 3, rtol=1e-6)


def test_calibration_quantiles_match_jax(jax_variables):
    """The quantiles the p95 threshold comes from, per frame and image, from
    the oracle pose and the (here untrained) flow: the port's from one call
    for both frames' maps, JAX's as the JAX tool computes them."""
    from mdn_sfm_tpu.data.augment import augment_batch as j_augment
    from mdn_sfm_tpu.geometry import epipolar_residual, scale_factor, transformation_from_parameters

    cfg, jcfg, models, oracle, tmodels = jax_variables
    E.pose_oracle(tmodels)
    colors, K, _, _, _ = moving_object_batch(B, H, W, seed=50_000, **WORLD)
    got = E.residual_quantiles(cfg, tmodels, {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)})
    jc, inv_Ks, _ = j_augment(jcfg, jnp.asarray(colors), jnp.asarray(K), jax.random.PRNGKey(0), train=False)
    want = []
    for t in (-1, 1):
        flows, _ = models.flow.apply(oracle["flownet"], jc[(0, 0)], jc[(t, 0)])
        aa, tr = models.pose.apply(oracle["posenet"], jc[(0, 0)], jc[(t, 0)])
        cam = transformation_from_parameters(aa, tr)
        e = jnp.abs(epipolar_residual(flows[0] * scale_factor(H, W), inv_Ks[0], cam[:, :3, :3], cam[:, :3, 3]))
        want.append(jnp.quantile(e.reshape(B, -1), jnp.linspace(0.0, 1.0, E.CALIB_LEVELS), axis=1))
    want = np.stack([np.asarray(w) for w in want])
    assert got.shape == want.shape == (2, E.CALIB_LEVELS, B)
    np.testing.assert_allclose(got, want, rtol=QUANTILE_ATOL, atol=QUANTILE_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_phase2_step_matches_jax(jax_variables, mode, tmp_path):
    """One phase-2 step of each mode (DS/DC on the world's GT masks) from
    the same frozen flow and pose and fresh decoder, float32 and no
    augmentation on both sides: the loss terms and grad_norm."""
    _, _, _, oracle, _ = jax_variables
    cfg = E.phase2_config(_args(), mode, "semantic_gt" if mode in ("DS", "DC") else None, 1.69, str(tmp_path))
    cfg = dataclasses.replace(cfg, disable_augment=True)
    jcfg = dataclasses.replace(_jax_cfg(cfg, tmp_path), donate_state=False)
    colors, K, mask, _, _ = moving_object_batch(B, H, W, seed=100_000, **WORLD)
    batch = {"colors_u8": colors, "K": K, "instance_mask": mask}
    if mode not in ("DS", "DC"):
        del batch["instance_mask"]
    models = JT.build_models(jcfg)
    tx = JT.make_optimizer(jcfg, 10)
    state, frozen = JT.create_train_state(jcfg, models, oracle, tx)
    _, _, jm, _ = JT.make_train_step(jcfg, models, tx)(state, frozen, batch, jax.random.PRNGKey(1))

    tmodels = TT.build_models(cfg, device="cpu")
    for net, module in TT.modules_by_name(tmodels).items():
        module.load_state_dict(state_dict_from_flax(net, oracle[net]), strict=True)
    tm, _ = TT.train_step(cfg, tmodels, TT.make_optimizer(cfg, tmodels, 10),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == {k for k in jm}
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=STEP_RTOL, err_msg=k)


def test_crafted_detector_equals_the_jax_fixture():
    import mdn_sfm_tpu.masks.maskrcnn as M
    from fixtures import craft_brightness_detector
    from mdn_sfm_tpu_torch.masks.crafted import brightness_detector_state_dict
    from mdn_sfm_tpu_torch.weights import maskrcnn_state_dict_from_flax

    shapes = jax.eval_shape(M.MaskRCNN(max_det=8).init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                            jnp.array(64.0), jnp.array(64.0))
    want = maskrcnn_state_dict_from_flax(craft_brightness_detector(shapes))
    got = brightness_detector_state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_phase1_cuts_flow_epe():
    """Phase 1 through the port's fine-tune step: 30 photometric steps at
    lr 3e-4 (f32, the JAX package's test_flow_epe_drops) cut the eval
    world's flow EPE below 0.7 of its start, and leave the oracle's head
    as it was (the photometric loss gives it no gradient)."""
    from mdn_sfm_tpu.metrics import compute_epe

    cfg = dataclasses.replace(E.phase1_config(_args()), num_epochs=1)
    models = TT.build_models(cfg, torch.Generator().manual_seed(0), "cpu")
    E.pose_oracle(models)
    ev_c, ev_K, _, ev_f, times = moving_object_batch(B, H, W, seed=999)

    def epe():
        flows, _ = E.clean_forward(cfg, models, E.augment_batch(cfg, torch.from_numpy(ev_c),
                                                                torch.from_numpy(ev_K), train=False)[0])
        gt = ev_f[:, times.index(1)]
        return float(np.mean([compute_epe(gt[b], flows[1][b], np.ones((H, W), np.float32)) for b in range(B)]))

    epe0 = epe()
    opt = TT.make_optimizer(cfg, models, 100)
    for s in range(30):
        c, K, _, _, _ = moving_object_batch(B, H, W, seed=s)
        m, _ = TT.train_step(cfg, models, opt, {"colors_u8": torch.from_numpy(c), "K": torch.from_numpy(K)},
                             generator=TT.step_generator(1, s, "cpu"))
        assert np.isfinite(float(m["photo"]))
    epe1 = epe()
    assert epe1 < 0.7 * epe0, (epe0, epe1)
    head = models.pose.decoder.pose_net[3]
    assert float(head.weight.abs().max()) == 0.0
    assert head.bias.tolist() == [0.0, 0.0, 0.0, 100.0, 0.0, 0.0]


def test_phase1_alone_records_each_group(tmp_path, capsys):
    """``--modes ""`` runs phase 1 and the calibration and no phase-2 row;
    the record holds each group's photometric loss, the eval world's
    largest |flow| and EPE, and ``--verbose`` prints them a group a line.
    ``--compute_dtype`` sets the nets' type (float32 by default on the
    CPU)."""
    assert E.phase1_config(_args()).compute_dtype == "float32"
    assert E.phase1_config(_args(compute_dtype="bfloat16")).compute_dtype == "bfloat16"
    args = _args(modes="", eval_batch=2, steps1=4, k_steps=2, obj_shift=6, obj_size=8, log_dir=str(tmp_path / "log"))
    args.bright_world = args.verbose = True
    record: dict = {}
    out = E.run(args, record)
    assert out["modes"] == {} and "sep" not in out
    groups = record["phase1_groups"]
    assert len(groups) == 2 and record["phase1"]["steps"] == 4
    for g in groups:
        assert set(g) == {"photo", "max_abs_flow_px", "epe"} and np.isfinite(list(g.values())).all(), g
    assert groups[-1]["photo"] == out["photo_final"]
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("phase1 group")]
    assert len(lines) == 2 and all("max|flow|=" in ln and "epe=" in ln for ln in lines), lines


def _jax_tool_keys() -> tuple[set, set]:
    """The top-level and per-row keys of the JAX tool's JSON, read from its
    source: ``results[...]``, the first row's fields it lifts, and each
    ``row`` entry."""
    with open(os.path.join(ROOT, "tools", "synthetic_e2e.py")) as f:
        src = f.read()
    body = src[src.index("def run("):src.index("def main(")]
    top = set(re.findall(r'results\["(\w+)"\]', body))
    top |= set(re.findall(r'"(\w+)"', re.search(r"for kk in\s*\((.*?)\)\}", body, re.S).group(1)))
    row = set(re.findall(r'"(\w+)":', re.search(r"row: dict = \{(.*?)\}", body, re.S).group(1)))
    row |= set(re.findall(r'row\["(\w+)"\]', body))
    row |= set(re.findall(r"(\w+)=", re.search(r"row\.update\((.*?)\)", body, re.S).group(1)))
    return top, row


def test_cli_end_to_end_on_the_cpu(tmp_path):
    """Every mode and both supervision sources at tiny budgets: one JSON
    line with the JAX tool's keys, finite scores, a ``sup_mask_iou`` on the
    live provider's rows."""
    res = subprocess.run(
        [sys.executable, "-m", "mdn_sfm_tpu_torch.synthetic_e2e", "--device", "cpu", "--height", str(H),
         "--width", str(W), "--batch_size", str(B), "--eval_batch", "2", "--steps1", "4", "--steps2", "2",
         "--k_steps", "2", "--tg_steps_mult", "1", "--modes", ",".join(MODES),
         "--ds_providers", "semantic_gt,maskrcnn@2", "--bright_world", "--obj_shift", "6", "--obj_size", "8",
         "--log_dir", str(tmp_path / "log")],
        cwd=ROOT, capture_output=True, text=True, timeout=600, env=ONE_THREAD)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    top, row = _jax_tool_keys()
    assert set(out) == top
    assert list(out["modes"]) == ["SN", "T", "TG", "DS", "DS@maskrcnn@2", "DC", "DC@maskrcnn@2"]
    for tag, r in out["modes"].items():
        live = "@maskrcnn" in tag
        want = row - ({"provider"} if tag in ("SN", "T", "TG") else set()) - (set() if live else {"sup_mask_iou"})
        assert set(r) == want, tag
        assert np.isfinite([r["sep"], r["loss_final"], r["best_f1"]]).all(), tag
    assert out["modes"]["TG"]["lr2"] == pytest.approx(3e-4) and out["modes"]["TG"]["steps2"] == 2
    assert np.isfinite([out["epe_init"], out["epe_trained"], out["calibrated_threshold_p95"]]).all()
    assert os.path.exists(os.path.join(tmp_path, "log", "e2e_v0", "models", "weights_0", "flownet.pth"))


def test_cli_checks_the_providers_before_training(tmp_path):
    for argv, match in ((["--ds_providers", "bogus"], "unknown spec"),
                        (["--ds_providers", "maskrcnn@2"], "needs --bright_world")):
        res = subprocess.run([sys.executable, "-m", "mdn_sfm_tpu_torch.synthetic_e2e", "--device", "cpu",
                              "--modes", "DS", *argv, "--log_dir", str(tmp_path)],
                             cwd=ROOT, capture_output=True, text=True, timeout=300, env=ONE_THREAD)
        assert res.returncode != 0 and match in res.stderr
