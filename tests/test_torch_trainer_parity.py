"""The port's Trainer against the JAX package's Trainer on the CPU: the same
carried weights (the JAX Trainer's initial variables, exported with
``export_pth`` into ``v0/weights_0`` for flow/pose and into a ``--v_load``
folder for the mobile decoder, which the port's Trainer reads), the same
synthetic data and batch order, ``disable_augment`` and float32, TG mode.
Per-step losses must agree at the tolerances
``tests/test_torch_train_step.py`` uses; the percentile tool must give the
same quantiles; JAX's optax state, carried into the port's Adam by
``weights.adam_state_from_optax`` with JAX's params, must take the same
next step; and the README's JAX → ``.pth`` command must turn the JAX
Trainer's checkpoint into one the port resumes exactly."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import checkpoints as JC
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.config import Mode as JMode
from mdn_sfm_tpu.trainer import Trainer as JTrainer
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.trainer import Trainer
from mdn_sfm_tpu_torch.weights import adam_state_from_optax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

STEPS = 3
# f32 on both sides, summed in another order: step 0 from equal params
# (~1e-6 relative), later steps after Adam's ±lr updates of the elements
# whose gradient sits at the f32 noise floor (test_torch_train_step.py)
LOSS_RTOL = (1e-5, 3e-5, 3e-5)
NEXT_RTOL = 3e-5
# post-Adam params: as test_torch_train_step.py, 2e-5 but for the
# noise-floor elements, which stay within 2·lr a step
PARAM_ATOL = 2e-5
NOISE_FLOOR_SHARE = 1e-4
LR = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# quantiles of the |residual| maps from f32 nets: an order statistic moves
# by at most the maps' largest elementwise difference, which follows the
# two frameworks' f32 flow (measured 1.03e-5 at the smallest quantiles,
# whose values are ~1e-3; the atol is three times that)
STATICS_RTOL, STATICS_ATOL = 1e-4, 3e-5

KW = dict(height=32, width=64, batch_size=2, num_epochs=1, num_workers=1, log_frequency=100,
          save_frequency=10**6, compute_dtype="float32", mode="TG", threshold=9.22, w_d2_sim=0.0,
          disable_augment=True, limit_train_samples=2 * STEPS, load_adam=True, v_load="vinit", idx_load=0,
          # one device: the JAX step on a mesh of the test run's virtual
          # CPU devices reports grad_norm times the device count
          num_data_shards=1)


class QuietTrainer(Trainer):
    def _make_writers(self):
        return None


class QuietJTrainer(JTrainer):
    def _make_writers(self):
        return None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parity"))
    log_dir = os.path.join(tmp, "log")
    jcfg = JConfig(log_dir=log_dir, v_save="vjax", donate_state=False,
                   other_files_path=os.path.join(tmp, "files_jax"),
                   **dict(KW, mode=JMode.TG)).validate()
    # the JAX Trainer initializes from its seed (no checkpoint on disk yet);
    # its variables are the weights both Trainers then train from
    jt = QuietJTrainer(jcfg, synthetic=True)
    variables = jax.device_get({**jt.frozen, "mobile_decoder": {"params": jt.state.params["mobile_decoder"]}})
    for folder, nets in ((JC.weights_folder(log_dir, "v0", 0), ("flownet", "posenet")),
                         (JC.weights_folder(log_dir, "vinit", 0), ("mobile_decoder",))):
        for n in nets:
            JC.export_pth(os.path.join(folder, f"{n}.pth"), n, variables[n])

    def recorder(t, out, jax_side):
        inner = t.step_fn

        def step(*args):
            res = inner(*args)
            out.append({k: float(v) for k, v in (res[2] if jax_side else res[0]).items()})
            return res

        t.step_fn = step

    jmetrics = []
    recorder(jt, jmetrics, True)
    jt.train()

    cfg = Config(log_dir=log_dir, v_save="vport", other_files_path=os.path.join(tmp, "files_port"),
                 **KW).validate()
    tt = QuietTrainer(cfg, synthetic=True, device="cpu")
    tmetrics = []
    recorder(tt, tmetrics, False)
    tt.train()
    return variables, jt, jmetrics, tt, tmetrics


def test_both_trainers_start_from_the_carried_weights(runs):
    variables, jt, _, tt, _ = runs
    fresh = QuietTrainer(dataclasses.replace(tt.cfg, v_save="vcheck"), synthetic=True, device="cpu")
    for net, module in (("flownet", fresh.models.flow), ("posenet", fresh.models.pose),
                        ("mobile_decoder", fresh.models.mobile)):
        want = state_dict_from_flax(net, variables[net])
        for k, v in module.state_dict().items():
            assert torch.equal(v, want[k]), (net, k)
    assert jt.start_step == tt.start_step == 0 and tt.opt.count == STEPS


def test_both_trainers_take_the_same_batches(runs):
    _, jt, _, tt, _ = runs
    jt.train_loader.epoch = 0
    assert [idxs for _, idxs in tt.sample_history] == [[int(i) for i in idxs] for _, idxs in jt.train_loader]


@pytest.mark.parametrize("step", range(STEPS))
def test_per_step_losses_match_jax(runs, step):
    _, _, jm, _, tm = runs
    assert len(jm) == len(tm) == STEPS
    assert set(tm[step]) == set(jm[step])
    for k in jm[step]:
        np.testing.assert_allclose(tm[step][k], jm[step][k], rtol=LOSS_RTOL[step], err_msg=k)


def test_epipolar_statics_match_jax(runs):
    """The percentile tool on the same frozen nets and batches: per-image
    quantiles of the |residual| maps (the port's from one call for both
    frames, ``torch.quantile`` linear; JAX's ``jnp.quantile``), f32 nets
    summed in another order."""
    _, jt, _, tt, _ = runs
    out = {}
    for name, t in (("jax", jt), ("port", tt)):
        t.train_loader.epoch = 5
        thresholds = t.epipolar_statics(num_quantile=20, max_batches=2)
        out[name] = thresholds, np.load(os.path.join(t.cfg.other_files_path, "eigen_zhou_percentiles.npy"))
    assert out["port"][1].shape == out["jax"][1].shape == (2, 20, 4)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=STATICS_RTOL, atol=STATICS_ATOL)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=STATICS_RTOL, atol=STATICS_ATOL)


def test_optax_state_continues_to_the_same_next_step(runs):
    """JAX's params and optax state after the run, carried into the port,
    take the same next step as JAX on the same batch."""
    _, jt, _, tt, _ = runs
    jparams = jax.device_get(jt.state.params["mobile_decoder"])
    models = T.build_models(tt.cfg, device="cpu")
    models.flow.load_state_dict(tt.models.flow.state_dict())
    models.pose.load_state_dict(tt.models.pose.state_dict())
    models.mobile.load_state_dict(state_dict_from_flax("mobile_decoder", {"params": jparams}))
    opt = T.make_optimizer(tt.cfg, models, tt.steps_per_epoch)
    opt.load_state_dict(adam_state_from_optax(jax.device_get(jt.state.opt_state),
                                              [n for n, _ in models.mobile.named_parameters()]))
    assert opt.count == STEPS

    arrays, _ = next(iter(jt.train_loader))
    jstate, _, jm, _ = jt.step_fn(jt.state, jt.frozen, jt._device_batch(arrays, []), jt.rng)
    batch = {"colors_u8": torch.from_numpy(arrays[0]), "K": torch.from_numpy(arrays[1])}
    tm, _ = T.train_step(tt.cfg, models, opt, batch)
    for k, v in jm.items():
        np.testing.assert_allclose(float(tm[k]), float(v), rtol=NEXT_RTOL, err_msg=k)
    want = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(jstate.params["mobile_decoder"])})
    diff = np.concatenate([(models.mobile.state_dict()[k] - v).abs().numpy().ravel() for k, v in want.items()])
    assert diff.max() <= 2 * LR
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE


def test_readme_conversion_resumes_in_the_port(runs):
    """The README's conversion command, run as written on a copy of the JAX
    Trainer's last checkpoint (flow and pose frozen: only the mobile
    decoder's and Adam's ``.msgpack``); the port's Trainer then resumes it
    with ``resume="auto"``: its params and Adam state equal the JAX
    Trainer's exactly, and it trains on for another epoch."""
    _, jt, _, tt, _ = runs
    with open(os.path.join(ROOT, "README.md")) as f:
        block = re.search(r"```bash\npython - \S+ \d+ <<'EOF'\n(.*?)\nEOF\n```", f.read(), re.S)
    run = os.path.join(tt.cfg.log_dir, "vconv")
    shutil.copytree(os.path.join(tt.cfg.log_dir, "vjax"), run)
    folder = JC.weights_folder(tt.cfg.log_dir, "vconv", 0)
    assert sorted(os.listdir(folder)) == ["adam.msgpack", "meta.json", "mobile_decoder.msgpack"]
    subprocess.run([sys.executable, "-", run, "0"], input=block.group(1), text=True, check=True, cwd=ROOT,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=600)
    assert {"mobile_decoder.pth", "adam.pth"} <= set(os.listdir(folder))

    cfg = dataclasses.replace(tt.cfg, v_save="vconv", resume="auto", num_epochs=2)
    t = QuietTrainer(cfg, synthetic=True, device="cpu")
    assert t.start_step == STEPS and t.base_step == 0
    want = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(jt.state.params["mobile_decoder"])})
    for k, v in t.models.mobile.state_dict().items():
        assert torch.equal(v, want[k]), k
    names = [n for n, _ in t.models.mobile.named_parameters()]
    adam = adam_state_from_optax(jax.device_get(jt.state.opt_state), names)
    assert t.opt.count == STEPS
    for i, (mu, nu) in enumerate(zip(t.opt.mu, t.opt.nu)):
        assert torch.equal(mu, adam["state"][i]["exp_avg"]) and torch.equal(nu, adam["state"][i]["exp_avg_sq"])
    t.train()
    assert t.step == t.opt.count == 2 * STEPS
    assert [s for s, _ in t.sample_history] == list(range(STEPS, 2 * STEPS))
