"""The port's K-step dispatch (``training.make_multi_train_step``) on the CPU.

Against the JAX package's ``make_multi_train_step`` (a ``lax.scan`` of K
steps): the same initial variables (carried with
``weights.state_dict_from_flax``), the same K = 3 synthetic batches,
``disable_augment`` and float32 on both sides, in the main path's TG mode;
with eval-mode BN (the default) and with ``bn_frozen_eval=False``, where the
dispatch carries the flow and pose nets' running statistics. Within the
port: a dispatch equals K single steps bit for bit, with the augmentation
drawn per step as a single step draws it."""

import jax
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode
from mdn_sfm_tpu.data.synthetic import synthetic_batch
from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

B, H, W = 2, 32, 64
K = 3
STEPS_PER_EPOCH = 10
# tests/test_torch_train_step.py's tolerances: 1e-5 relative on step 0's
# metrics, 3e-5 after Adam's first update. The K-step mean carries steps 1
# and 2, so it is held at 3e-5
MEAN_RTOL = 3e-5
AUX_ATOL = 1e-6              # the last step's min mobile map (the JAX package's own scan test)
# with bn_frozen_eval=False the frozen nets normalize with the stacked
# batch's statistics, which carry the f32 rounding of their activations into
# every map: the maps and the running statistics are held at rtol 1e-5 and
# atol 1e-6 there
BN_RTOL, BN_ATOL = 1e-5, 1e-6
PARAM_ATOL = 2e-5            # post-Adam params, except the noise-floor elements
NOISE_FLOOR_SHARE = 1e-4     # whose gradient sits at f32 noise: they step ±lr either way
LR = 1e-4

KW = dict(height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.0, compute_dtype="float32",
          disable_augment=True)


def _batches():
    pairs = [synthetic_batch(B, H, W, seed=s) for s in range(K)]
    return np.stack([c for c, _ in pairs]), np.stack([k for _, k in pairs])


@pytest.fixture(scope="module", params=[True, False], ids=["bn_eval", "bn_train"])
def runs(request):
    bn_frozen_eval = request.param
    colors, Ks = _batches()

    jcfg = JConfig(mode=JMode.TG, donate_state=False, bn_frozen_eval=bn_frozen_eval, **KW).validate()
    models = JT.build_models(jcfg)
    variables = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
    tx = JT.make_optimizer(jcfg, STEPS_PER_EPOCH)
    state, frozen = JT.create_train_state(jcfg, models, variables, tx)
    kstep = JT.make_multi_train_step(jcfg, models, tx)
    state, frozen, jm, jaux = kstep(state, frozen, {"colors_u8": colors, "K": Ks}, jax.random.PRNGKey(1))
    jmetrics = {k: float(v) for k, v in jm.items()}
    jparams = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(state.params["mobile_decoder"])})
    jstats = {net: state_dict_from_flax(net, jax.device_get(frozen[net])) for net in ("flownet", "posenet")}

    cfg = Config(mode=Mode.TG, bn_frozen_eval=bn_frozen_eval, **KW).validate()
    tmodels = TT.build_models(cfg, device="cpu")
    for net, module in zip(("flownet", "posenet", "mobile_decoder"), tmodels):
        module.load_state_dict(state_dict_from_flax(net, variables[net]), strict=True)
    opt = TT.make_optimizer(cfg, tmodels, STEPS_PER_EPOCH)
    multi = TT.make_multi_train_step(cfg, tmodels, opt, K)
    tm, taux = multi({"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(Ks)}, None)
    initial = {net: state_dict_from_flax(net, variables[net]) for net in ("flownet", "posenet")}
    return {"bn_frozen_eval": bn_frozen_eval, "initial_stats": initial,
            "jax": (jmetrics, np.asarray(jaux.min_mobiles[0]), jparams, jstats),
            "port": ({k: float(v) for k, v in tm.items()}, taux.min_mobiles[0].numpy(), tmodels, opt)}


def test_mean_metrics_match_jax(runs):
    jm, _, _, _ = runs["jax"]
    tm, _, _, opt = runs["port"]
    assert set(tm) == set(jm) and opt.count == K
    for k in jm:
        assert np.isfinite(tm[k]), k
        np.testing.assert_allclose(tm[k], jm[k], rtol=MEAN_RTOL, err_msg=k)


def test_last_step_aux_matches_jax(runs):
    _, jmin, _, _ = runs["jax"]
    _, tmin, _, _ = runs["port"]
    assert tmin.shape == jmin.shape == (B, H, W, 1)
    if runs["bn_frozen_eval"]:
        np.testing.assert_allclose(tmin, jmin, atol=AUX_ATOL)
    else:
        np.testing.assert_allclose(tmin, jmin, rtol=BN_RTOL, atol=BN_ATOL)


def test_post_dispatch_params_match_jax(runs):
    _, _, jparams, _ = runs["jax"]
    tparams = runs["port"][2].mobile.state_dict()
    assert set(jparams) == set(tparams)
    diff = np.concatenate([np.abs(tparams[k].numpy() - v.numpy()).ravel() for k, v in jparams.items()])
    assert diff.max() <= 2 * LR * K
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE


def test_bn_statistics_match_jax(runs):
    """Running statistics after the dispatch: updated K times with train-mode
    BN, untouched with eval-mode BN; equal to the JAX scan's carry."""
    _, _, _, jstats = runs["jax"]
    models = runs["port"][2]
    for net, module in (("flownet", models.flow), ("posenet", models.pose)):
        sd = module.state_dict()
        keys = [k for k in jstats[net] if k.endswith(("running_mean", "running_var"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(sd[k].numpy(), jstats[net][k].numpy(), rtol=BN_RTOL, atol=BN_ATOL,
                                       err_msg=f"{net}.{k}")
            moved = not torch.equal(sd[k], runs["initial_stats"][net][k])
            assert moved != runs["bn_frozen_eval"], f"{net}.{k}"


def _augmented_setup():
    cfg = Config(mode=Mode.TG, height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.0,
                 compute_dtype="float32").validate()
    colors, Ks = _batches()
    batches = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(Ks)}
    nets = [TT.build_models(cfg, torch.Generator().manual_seed(3), "cpu") for _ in range(2)]
    return cfg, batches, nets, [TT.make_optimizer(cfg, m, STEPS_PER_EPOCH) for m in nets]


def test_dispatch_equals_single_steps_bitwise():
    """With augmentation on, a dispatch from step 5 draws step 5 + j's
    augmentation from step_generator(seed, 5 + j), as the single steps do,
    and lands on their params, Adam state, metrics and last aux bit for bit."""
    cfg, batches, (m1, m2), (o1, o2) = _augmented_setup()
    multi = TT.make_multi_train_step(cfg, m1, o1, K)
    mean, aux = multi(batches, TT.multi_step_draws(cfg, batches, 5))
    singles = []
    for j in range(K):
        out, last = TT.train_step(cfg, m2, o2, {k: v[j] for k, v in batches.items()},
                                  generator=TT.step_generator(cfg.seed, 5 + j, "cpu"))
        singles.append(out)
    for k in singles[0]:
        per = torch.stack([s[k] for s in singles])
        assert torch.equal(multi.step_metrics[k], per), k
        assert torch.equal(mean[k], per.mean()), k
    for field in ("min_mobiles", "epipolars", "flows"):
        for key, v in getattr(last, field).items():
            assert torch.equal(getattr(aux, field)[key], v), (field, key)
    for a, b in zip(list(m1.mobile.parameters()) + o1.mu + o1.nu, list(m2.mobile.parameters()) + o2.mu + o2.nu):
        assert torch.equal(a, b)
    assert o1.count == o2.count == K


def test_dispatch_refuses_wrong_inputs():
    cfg, batches, (m1, _), (o1, _) = _augmented_setup()
    multi = TT.make_multi_train_step(cfg, m1, o1, K)
    with pytest.raises(ValueError, match="draws"):
        multi(batches, None)
    with pytest.raises(ValueError, match="3 batches"):
        multi({k: v[:2] for k, v in batches.items()}, TT.multi_step_draws(cfg, batches, 0))
    assert o1.count == 0
