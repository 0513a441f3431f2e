"""The slice as a whole: the port's train step against the JAX package's.

Same initial variables (converted with ``weights.state_dict_from_flax``),
same synthetic batch, ``disable_augment`` and float32 on both sides, the
main path's TG mode; after each of 2 steps the loss terms and ``grad_norm``,
and after both the post-Adam mobile-decoder params, must agree."""

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

B, H, W = 2, 64, 96
STEPS = 2
STEPS_PER_EPOCH = 10  # a decaying cosine LR, so the schedule is exercised
# f32 on both sides, summed in another order. Step 0 starts from equal
# params: ~1e-6 relative on the losses, 7e-6 on grad_norm. Adam's first
# updates are lr·g/|g| per element, so the few elements whose gradient sits
# at the f32 noise floor step by ±lr on either side; the metrics after that
# update move by ~1e-5 relative.
LOSS_RTOL = (1e-5, 3e-5)
# post-Adam params: the 2e-5 the JAX package's own accumulation test uses
# (config.py accum_steps), except those noise-floor elements (measured: 108
# of 3.2e6, 0.003 %), which stay within the 2·lr·steps a sign flip can move
PARAM_ATOL = 2e-5
NOISE_FLOOR_SHARE = 1e-4
LR = 1e-4  # Config.learning_rate

KW = dict(height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.0,
          compute_dtype="float32", disable_augment=True)


@pytest.fixture(scope="module")
def runs():
    colors, K = synthetic_batch(B, H, W, seed=0)

    jcfg = JConfig(mode=JMode.TG, donate_state=False, **KW).validate()
    models = JT.build_models(jcfg)
    variables = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
    tx = JT.make_optimizer(jcfg, STEPS_PER_EPOCH)
    state, frozen = JT.create_train_state(jcfg, models, variables, tx)
    step = JT.make_train_step(jcfg, models, tx)
    jbatch = {"colors_u8": colors, "K": K}
    jmetrics = []
    for _ in range(STEPS):
        state, frozen, m, _ = step(state, frozen, jbatch, jax.random.PRNGKey(1))
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
    return jmetrics, tmetrics, jparams, tmodels.mobile.state_dict()


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(runs, step):
    jm, tm, _, _ = runs
    assert set(tm[step]) == set(jm[step])
    for k in jm[step]:
        assert np.isfinite(tm[step][k]), k
        np.testing.assert_allclose(tm[step][k], jm[step][k], rtol=LOSS_RTOL[step], err_msg=k)


def test_post_adam_params_match_jax(runs):
    _, _, jparams, tparams = runs
    assert set(jparams) == set(tparams)
    diff = np.concatenate([np.abs(tparams[k].numpy() - v.numpy()).ravel() for k, v in jparams.items()])
    assert diff.max() <= 2 * LR * STEPS
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE


def test_frozen_nets_unchanged_and_no_grad(runs):
    cfg = Config(mode=Mode.TG, **KW).validate()
    models = TT.build_models(cfg, device="cpu")
    before = {k: v.clone() for k, v in models.flow.state_dict().items()}
    opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
    colors, K = synthetic_batch(B, H, W, seed=1)
    TT.train_step(cfg, models, opt, {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)})
    assert not models.flow.training and not models.pose.training
    assert all(not p.requires_grad for p in models.flow.parameters())
    for k, v in models.flow.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_lr_schedule_matches_optax():
    import optax

    cfg = Config(**KW, learning_rate=3e-4, num_epochs=2)
    ours = TT.lr_schedule(cfg, 7)
    theirs = optax.cosine_decay_schedule(3e-4, decay_steps=14)
    for k in (0, 1, 5, 13, 14, 20):
        np.testing.assert_allclose(ours(k), float(theirs(k)), rtol=1e-6)
    legacy = TT.lr_schedule(Config(**KW, learning_rate=3e-4, legacy_lr_schedule=True), 7)
    jlegacy = JT.lr_schedule(JConfig(**KW, learning_rate=3e-4, legacy_lr_schedule=True), 7)
    for k in (0, 3, 7, 10):
        np.testing.assert_allclose(legacy(k), float(jlegacy(k)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("norm", [0.5, 3.0])
def test_clip_and_adam_match_optax(norm):
    """One update of the written-out optimizer equals optax's chain, on both
    sides of the clip threshold."""
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    g = rng.normal(size=(5, 3)).astype(np.float32)
    g *= norm / np.linalg.norm(g)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-2, b1=0.9, b2=0.999))
    st = tx.init({"w": jnp.asarray(p0)})
    p = {"w": jnp.asarray(p0)}
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = TT.Adam([param], lambda k: 1e-2, 0.9, 0.999, clip=1.0)
    for _ in range(3):
        upd, st = tx.update({"w": jnp.asarray(g)}, st, p)
        p = optax.apply_updates(p, upd)
        gn = opt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(float(gn), norm, rtol=1e-6)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(p["w"]), rtol=1e-6, atol=1e-7)
