"""The TG step and the training entry point with a 50-layer pose net
(``--num_layers 50``, the bottleneck trunk), held against the JAX package on
the CPU.

The step: the same initial variables (the JAX package's init, carried by
``weights.state_dict_from_flax``), the same synthetic batch,
``disable_augment`` and float32 on both sides, 2 steps; the loss terms and
``grad_norm`` after each, and the decoder's post-Adam params after both, at
``tests/test_torch_train_step.py``'s bounds. The entry point: ``python -m
mdn_sfm_tpu_torch.train --num_layers 50 --fine_tune_flow_motion`` runs,
saves the bottleneck pose net, and continues exactly with ``--resume
auto``."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode
from mdn_sfm_tpu.data.synthetic import synthetic_batch
from mdn_sfm_tpu_torch import checkpoints as ckpt
from mdn_sfm_tpu_torch import models as tm
from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

B, H, W = 2, 32, 64
STEPS = 2
STEPS_PER_EPOCH = 10
LR = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on both sides, summed in another order: tests/test_torch_train_step.py's bounds
LOSS_RTOL = (1e-5, 3e-5)
PARAM_ATOL = 2e-5
NOISE_FLOOR_SHARE = 1e-4

KW = dict(height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.0, compute_dtype="float32",
          disable_augment=True, num_layers=50)


@pytest.fixture(scope="module")
def runs():
    colors, K = synthetic_batch(B, H, W, seed=0)
    jcfg = JConfig(mode=JMode.TG, donate_state=False, **KW).validate()
    models = JT.build_models(jcfg)
    variables = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
    tx = JT.make_optimizer(jcfg, STEPS_PER_EPOCH)
    state, frozen = JT.create_train_state(jcfg, models, variables, tx)
    step = JT.make_train_step(jcfg, models, tx)
    jmetrics = []
    for _ in range(STEPS):
        state, frozen, m, _ = step(state, frozen, {"colors_u8": colors, "K": K}, jax.random.PRNGKey(1))
        jmetrics.append({k: float(v) for k, v in m.items()})
    jparams = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(state.params["mobile_decoder"])})

    cfg = Config(mode=Mode.TG, **KW).validate()
    tmodels = TT.build_models(cfg, device="cpu")
    for net, module in zip(("flownet", "posenet", "mobile_decoder"), tmodels):
        module.load_state_dict(state_dict_from_flax(net, variables[net]), strict=True)
    opt = TT.make_optimizer(cfg, tmodels, STEPS_PER_EPOCH)
    tbatch = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)}
    tmetrics = [{k: float(v) for k, v in TT.train_step(cfg, tmodels, opt, tbatch)[0].items()}
                for _ in range(STEPS)]
    return dict(jmetrics=jmetrics, tmetrics=tmetrics, jparams=jparams, models=tmodels)


def test_pose_net_is_the_bottleneck_trunk(runs):
    pose = runs["models"].pose
    assert pose.encoder.num_ch_enc == (64, 256, 512, 1024, 2048)
    assert pose.decoder.pose_net[0].in_channels == 2048
    assert "encoder.encoder.layer3.5.conv3.weight" in pose.state_dict()
    assert runs["models"].flow.encoder.num_ch_enc == (64, 64, 128, 256, 512)  # FlowNet stays at ResNet-18


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(runs, step):
    jm, tm_ = runs["jmetrics"][step], runs["tmetrics"][step]
    assert set(tm_) == set(jm)
    for k in jm:
        assert np.isfinite(tm_[k]), k
        np.testing.assert_allclose(tm_[k], jm[k], rtol=LOSS_RTOL[step], err_msg=k)


def test_post_adam_decoder_params_match_jax(runs):
    jparams, tparams = runs["jparams"], runs["models"].mobile.state_dict()
    assert set(jparams) == set(tparams)
    diff = np.concatenate([np.abs(tparams[k].numpy() - v.numpy()).ravel() for k, v in jparams.items()])
    assert diff.max() <= 2 * LR * STEPS
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE


def _cli(*args: str, timeout: int = 600):
    # one thread, as the test workers run
    return subprocess.run([sys.executable, "-m", "mdn_sfm_tpu_torch.train", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_train_cli_with_50_layers_saves_and_resumes(tmp_path):
    """``--num_layers 50 --fine_tune_flow_motion`` on the CPU: the run
    saves the bottleneck pose net (it loads strictly into a 50-layer
    PoseNet) and Adam over the three nets; the run cut back to its step-3
    checkpoint and continued with ``--resume auto`` ends where the
    uninterrupted run ended, bit for bit (float32, as
    ``tests/test_torch_fine_tune.py`` says why)."""
    log = str(tmp_path / "log")
    common = ["--synthetic", "--device", "cpu", "--batch_size", "2", "--height", "32", "--width", "64",
              "--limit_train_samples", "8", "--save_frequency", "3", "--num_workers", "1", "--mode", "TG",
              "--w_d2_sim", "0", "--fine_tune_flow_motion", "--num_layers", "50", "--num_epochs", "1",
              "--compute_dtype", "float32", "--log_dir", log]
    res = _cli(*common, "--v_save", "va")
    assert res.returncode == 0, res.stderr
    assert Config.load(os.path.join(log, "va", "models", "opt.json")).num_layers == 50
    # weights_0 at step 3, weights_1 at the end (step 4)
    assert [ckpt.read_meta(ckpt.weights_folder(log, "va", i))["step"] for i in range(2)] == [3, 4]
    pose = tm.PoseNet(num_layers=50)
    pose.load_state_dict(torch.load(os.path.join(ckpt.weights_folder(log, "va", 1), "posenet.pth"),
                                    weights_only=True), strict=True)
    shutil.copytree(ckpt.weights_folder(log, "va", 0), ckpt.weights_folder(log, "vb", 0))
    res = _cli(*common, "--v_save", "vb", "--resume", "auto")
    assert res.returncode == 0, res.stderr
    folders = [ckpt.weights_folder(log, "va", 1), ckpt.weights_folder(log, "vb", 1)]
    for f in folders:
        assert sorted(os.listdir(f)) == ["adam.pth", "flownet.pth", "meta.json", "mobile_decoder.pth",
                                         "posenet.pth"]
        assert ckpt.read_meta(f)["step"] == 4
    for name in ("flownet.pth", "posenet.pth", "mobile_decoder.pth"):
        a, b = (torch.load(os.path.join(f, name), weights_only=True) for f in folders)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    a, b = (torch.load(os.path.join(f, "adam.pth"), weights_only=True) for f in folders)
    n_pose = len(list(pose.parameters()))
    assert n_pose == 53 + 2 * 53 + 2 * 4  # the trunk's convolutions and BN layers (scale, bias), the head's 4 convs
    assert len(a["state"]) == len(b["state"]) == 28 + 88 + n_pose  # the decoder's, flow's and pose's params
    for i in a["state"]:
        assert float(a["state"][i]["step"]) == 4
        assert torch.equal(a["state"][i]["exp_avg"], b["state"][i]["exp_avg"])
        assert torch.equal(a["state"][i]["exp_avg_sq"], b["state"][i]["exp_avg_sq"])


def test_pose50_step_one_amplifies_one_ulp():
    """Why chip_smoke.py's phase 14 holds the 50-layer pose net's f32 step 1
    on the card against the CPU at 1e-4, not phase 5's 3e-5 (64×96, batch
    2, seed-0 weights, one thread): moving every flow or decoder param by
    one ulp, up or down, moves step 0's metrics by under 1e-5 relative
    (measured 1.4e-6 to 5.5e-6) and step 1's, after Adam's first update has
    acted on it, by up to about phase 5's whole bound (measured 1.2e-5 to
    3.05e-5): elements of the decoder's gradient at the f32 noise floor flip
    the sign of their update. The card sums the convolutions in another
    order than the CPU, which moves more than one ulp."""
    colors, K = synthetic_batch(2, 64, 96, seed=0)
    batch = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)}
    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                 compute_dtype="float32", disable_augment=True, num_layers=50).validate()

    def run(net=None, direction=1.0):
        models = TT.build_models(cfg, torch.Generator().manual_seed(0), "cpu")
        if net:
            with torch.no_grad():
                for p in getattr(models, net).parameters():
                    p.copy_(torch.nextafter(p, torch.full_like(p, direction * float("inf"))))
        opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
        return [{k: float(v) for k, v in TT.train_step(cfg, models, opt, batch)[0].items()} for _ in range(2)]

    base = run()
    rel = []
    for net in ("flow", "mobile"):
        for direction in (1.0, -1.0):
            moved = run(net, direction)
            rel.append([max(abs(moved[s][k] - base[s][k]) / abs(base[s][k]) for k in base[s]) for s in range(2)])
    assert max(r[0] for r in rel) < 1e-5, rel
    # the largest about phase 5's 3e-5, with phase 14's 1e-4 twice above it
    assert 1.5e-5 < max(r[1] for r in rel) < 5e-5, rel
