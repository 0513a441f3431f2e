"""Fine-tuning flow and pose: the port's step against the JAX package's.

One JAX run: ``fine_tune_flow_motion`` with the photometric loss on (so the
inverse warp's gradient reaches the flow net) and ``skip_nonfinite_updates``
(``optax.apply_if_finite`` around the chain), TG, float32,
``disable_augment``, 2 steps from the same carried weights. After each step
the loss terms and ``grad_norm``, after both the post-Adam params of all
three nets, must agree. The JAX run's state, saved as the JAX Trainer saves
it, is then converted by the README's command and resumed by the port's
Trainer. (Train-mode BN is held against JAX with frozen nets in
``test_torch_step_options.py``: with fine-tuning as well, the gradient
through the batch statistics of layer4's 8 values a channel amplifies the
two frameworks' roundings, 1.4e-5 relative after one update at 32×64 and
8.3e-4 after two at 64×96, beyond any bound this file could state.)"""

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

from mdn_sfm_tpu import checkpoints as JC
from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode
from mdn_sfm_tpu.data.synthetic import synthetic_batch
from mdn_sfm_tpu_torch import checkpoints as ckpt
from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.trainer import Trainer
from mdn_sfm_tpu_torch.weights import adam_state_from_optax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (module-scoped fixture)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

B, H, W = 2, 32, 64
STEPS = 2
STEPS_PER_EPOCH = 10
LR = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("flownet", "posenet", "mobile_decoder")
# f32 on both sides, summed in another order: the bounds of
# tests/test_torch_train_step.py. Step 0 starts from equal params; step 1
# follows Adam's first ±lr updates of the elements whose gradient sits at
# the f32 noise floor (measured here: metrics within 9.8e-7 and 6.7e-7
# relative; step-0 gradients within 1.2e-5 (flow) and 1.6e-5 (pose) in norm,
# signs differing only where |g| < 7.2e-7)
LOSS_RTOL = (1e-5, 3e-5)
PARAM_ATOL = 2e-5
NOISE_FLOOR_SHARE = 1e-4

KW = dict(height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.0, compute_dtype="float32",
          disable_augment=True, fine_tune_flow_motion=True, skip_nonfinite_updates=True,
          disable_photoloss=False)


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
    state, frozen = jax.device_get(state), jax.device_get(frozen)

    cfg = Config(mode=Mode.TG, **KW).validate()
    tmodels = TT.build_models(cfg, device="cpu")
    for net, module in zip(NETS, (tmodels.flow, tmodels.pose, tmodels.mobile)):
        module.load_state_dict(state_dict_from_flax(net, variables[net]), strict=True)
    opt = TT.make_optimizer(cfg, tmodels, STEPS_PER_EPOCH)
    tbatch = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)}
    tmetrics = [{k: float(v) for k, v in TT.train_step(cfg, tmodels, opt, tbatch)[0].items()}
                for _ in range(STEPS)]
    return dict(jcfg=jcfg, state=state, frozen=frozen, jmetrics=jmetrics, cfg=cfg, models=tmodels, opt=opt,
                tmetrics=tmetrics)


def _jax_net(runs, net) -> dict:
    """A net's variables after the JAX run: params and BN statistics."""
    v = {"params": runs["state"].params[net]}
    if net != "mobile_decoder":
        v["batch_stats"] = runs["frozen"][net]["batch_stats"]
    return state_dict_from_flax(net, v)


def _port_net(runs, net):
    return TT.modules_by_name(runs["models"])[net]


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(runs, step):
    jm, tm = runs["jmetrics"][step], runs["tmetrics"][step]
    assert set(tm) == set(jm) == {"loss", "epip", "smooth", "consis", "photo", "grad_norm"}
    for k in jm:
        assert np.isfinite(tm[k]), k
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL[step], err_msg=k)


@pytest.mark.parametrize("net", NETS)
def test_post_adam_params_match_jax(runs, net):
    want = _jax_net(runs, net)
    params = dict(_port_net(runs, net).named_parameters())
    assert set(params) <= set(want)
    diff = np.concatenate([np.abs(p.detach().numpy() - want[k].numpy()).ravel() for k, p in params.items()])
    assert diff.max() <= 2 * LR * STEPS
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE


@pytest.mark.parametrize("net", ("flownet", "posenet"))
def test_eval_bn_statistics_stay_as_loaded(runs, net):
    """Fine-tuning with eval-mode BN trains the BN scales and biases but
    leaves the running averages, as the JAX package's frozen tree does."""
    want = _jax_net(runs, net)
    for k, v in _port_net(runs, net).named_buffers():
        assert torch.equal(v, want[k]), k


def test_flow_and_pose_train_and_rest_in_eval_mode(runs):
    cfg, models, opt = runs["cfg"], runs["models"], runs["opt"]
    assert TT.trainable_nets(cfg) == ("mobile_decoder", "flownet", "posenet")
    n = [len(list(m.parameters())) for m in (models.mobile, models.flow, models.pose)]
    assert len(opt.params) == sum(n) and opt.count == STEPS
    assert [p is q for p, q in zip(opt.params, [*models.mobile.parameters(), *models.flow.parameters(),
                                                *models.pose.parameters()])] == [True] * sum(n)
    assert all(p.requires_grad for p in opt.params)
    assert not models.flow.training and not models.pose.training
    assert (int(opt.notfinite_count), int(opt.total_notfinite), bool(opt.last_finite)) == (0, 0, True)


def test_eval_forward_takes_the_running_averages():
    """With train-mode BN in the step (which moves the running averages),
    the eval forward normalizes with the averages and leaves them as they
    are; a frozen-BN forward on the same nets gives the same flow."""
    cfg = Config(mode=Mode.TG, **dict(KW, bn_frozen_eval=False)).validate()
    models = TT.build_models(cfg, device="cpu")
    opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
    colors, K = synthetic_batch(B, H, W, seed=5)
    init = {k: v.clone() for k, v in models.flow.state_dict().items()}
    TT.train_step(cfg, models, opt, {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)})
    moved = {k: v.clone() for k, v in models.flow.state_dict().items()}
    assert not torch.equal(moved["encoder.encoder.bn1.running_mean"], init["encoder.encoder.bn1.running_mean"])
    x = torch.from_numpy(colors[:, 0]).float().div(255.0)
    flows, _, _, _, _ = TT.eval_forward(cfg, models, x, x)
    with torch.no_grad():
        want, _, _, _, _ = TT.forward_frame(dataclasses.replace(cfg, bn_frozen_eval=True), models, x, x)
    assert torch.equal(flows[0], want[0])
    for k, v in models.flow.state_dict().items():
        assert torch.equal(v, moved[k]), k
    assert not models.flow.training and not models.pose.training


def test_photometric_warp_gradient_matches_jax():
    """The gradient of the photometric loss through the bilinear inverse
    warp, with respect to the flow and the reference image, against
    jax.grad of the JAX package's loss (L1 and with SSIM)."""
    from mdn_sfm_tpu.losses import photometric_loss as jloss
    from mdn_sfm_tpu_torch.losses import photometric_loss

    rng = np.random.default_rng(3)
    tgt = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    ref = rng.uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 16, 24, 2)).astype(np.float32)  # some samples out of bounds
    for use_ssim in (False, True):
        jg = jax.grad(lambda f, r: jloss(jnp.asarray(tgt), r, f, use_ssim)[0], argnums=(0, 1))(
            jnp.asarray(flow), jnp.asarray(ref))
        f_t, r_t = torch.from_numpy(flow).requires_grad_(), torch.from_numpy(ref).requires_grad_()
        loss = photometric_loss(torch.from_numpy(tgt), r_t, f_t, use_ssim)[0]
        tg = torch.autograd.grad(loss, (f_t, r_t))
        for got, want in zip(tg, jg):
            want = np.asarray(want)
            assert float(np.abs(want).max()) > 0
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-7 * float(np.abs(want).max()))


def test_readme_conversion_resumes_a_fine_tune_in_the_port(runs, tmp_path):
    """The JAX run's state saved as the JAX Trainer saves a fine-tune
    checkpoint (three nets with their BN statistics, the apply_if_finite
    optax state, opt.json), converted by the README's command; the port's
    Trainer resumes it with ``resume="auto"``: every net and the Adam state
    equal JAX's exactly, and it trains on."""
    run = str(tmp_path / "log" / "vft")
    folder = JC.weights_folder(str(tmp_path / "log"), "vft", 0)
    variables = {n: {"params": runs["state"].params[n]} for n in NETS}
    for n in ("flownet", "posenet"):
        variables[n]["batch_stats"] = runs["frozen"][n]["batch_stats"]
    jcfg = dataclasses.replace(runs["jcfg"], log_dir=str(tmp_path / "log"), v_save="vft", num_workers=1,
                               limit_train_samples=2 * B, num_epochs=2, save_frequency=10**6)
    jcfg.save(os.path.join(run, "models", "opt.json"))
    JC.save_checkpoint(folder, variables, runs["state"].opt_state, STEPS, NETS)
    with open(os.path.join(ROOT, "README.md")) as f:
        block = re.search(r"```bash\npython - \S+ \d+ <<'EOF'\n(.*?)\nEOF\n```", f.read(), re.S)
    subprocess.run([sys.executable, "-", run, "0"], input=block.group(1), text=True, check=True, cwd=ROOT,
                   env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=600)
    assert {"flownet.pth", "posenet.pth", "mobile_decoder.pth", "adam.pth"} <= set(os.listdir(folder))

    class QuietTrainer(Trainer):
        def _make_writers(self):
            return None

    with open(os.path.join(run, "models", "opt.json")) as f:
        opts = json.load(f)
    cfg = dataclasses.replace(Config.load(os.path.join(run, "models", "opt.json")), resume="auto")
    assert opts["fine_tune_flow_motion"] and cfg.fine_tune_flow_motion and cfg.skip_nonfinite_updates
    t = QuietTrainer(cfg, synthetic=True, device="cpu")
    assert t.start_step == STEPS
    for n in NETS:
        want = _jax_net(runs, n)
        got = TT.modules_by_name(t.models)[n].state_dict()
        assert set(got) == set(want), n
        for k, v in got.items():
            assert torch.equal(v, want[k]), (n, k)
    adam = adam_state_from_optax(runs["state"].opt_state, TT.trainable_param_names(cfg))
    assert t.opt.count == STEPS and len(t.opt.params) == len(adam["state"])
    for i, (mu, nu) in enumerate(zip(t.opt.mu, t.opt.nu)):
        assert torch.equal(mu, adam["state"][i]["exp_avg"]) and torch.equal(nu, adam["state"][i]["exp_avg_sq"])
    assert adam["param_groups"][0]["notfinite_count"] == int(t.opt.notfinite_count) == 0
    t.train()
    assert t.step == t.opt.count == STEPS + 2
    latest = ckpt.weights_folder(cfg.log_dir, "vft", ckpt.latest_weights_idx(cfg.log_dir, "vft"))
    assert {"flownet.pth", "posenet.pth", "mobile_decoder.pth", "adam.pth", "meta.json"} <= set(os.listdir(latest))


def _cli(*args: str, timeout: int = 300):
    # one thread, as the test workers run
    return subprocess.run([sys.executable, "-m", "mdn_sfm_tpu_torch.train", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_train_cli_fine_tunes_saves_and_resumes(tmp_path):
    """``--fine_tune_flow_motion`` on the CPU: every checkpoint holds the
    three nets and Adam over all of them; the run cut back to its step-2
    checkpoint and continued with ``--resume auto`` ends where the
    uninterrupted run ended, bit for bit. (float32: on the CPU, PyTorch's
    bf16 autocast backward of the pose head's padded 3×3 stride-2 conv over
    a 1×1 map puts varying values on the padding taps of its weight's
    gradient, so bf16 runs on the CPU do not repeat bit for bit.)"""
    import shutil

    log = str(tmp_path / "log")
    common = ["--synthetic", "--device", "cpu", "--batch_size", "2", "--height", "32", "--width", "64",
              "--limit_train_samples", "4", "--save_frequency", "2", "--num_workers", "1", "--mode", "TG",
              "--w_d2_sim", "0", "--fine_tune_flow_motion", "--num_epochs", "2", "--compute_dtype", "float32",
              "--log_dir", log]
    res = _cli(*common, "--v_save", "va")
    assert res.returncode == 0, res.stderr
    # weights_0 at step 2, weights_1 at step 4 and weights_2 at the end
    assert [ckpt.read_meta(ckpt.weights_folder(log, "va", i))["step"] for i in range(3)] == [2, 4, 4]
    shutil.copytree(ckpt.weights_folder(log, "va", 0), ckpt.weights_folder(log, "vb", 0))
    res = _cli(*common, "--v_save", "vb", "--resume", "auto")
    assert res.returncode == 0, res.stderr
    folders = [ckpt.weights_folder(log, "va", 2), ckpt.weights_folder(log, "vb", 2)]
    for f in folders:
        assert sorted(os.listdir(f)) == ["adam.pth", "flownet.pth", "meta.json", "mobile_decoder.pth",
                                         "posenet.pth"]
        assert ckpt.read_meta(f)["step"] == 4
    for name in ("flownet.pth", "posenet.pth", "mobile_decoder.pth"):
        a, b = (torch.load(os.path.join(f, name), weights_only=True) for f in folders)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    a, b = (torch.load(os.path.join(f, "adam.pth"), weights_only=True) for f in folders)
    assert len(a["state"]) == len(b["state"]) == 28 + 88 + 68  # the decoder's, flow's and pose's params
    for i in a["state"]:
        assert float(a["state"][i]["step"]) == 4
        assert torch.equal(a["state"][i]["exp_avg"], b["state"][i]["exp_avg"])
