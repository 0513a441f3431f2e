"""The port's DS and DC train steps with precomputed instance masks against
the JAX package's step: the same initial variables (carried with
``weights.state_dict_from_flax``), the same synthetic batch and union masks
(read by both packages' ``PrecomputedMaskProvider`` from the same PNGs),
``disable_augment`` and float32 on both sides. After each of 2 steps the
loss terms and ``grad_norm``, and after both the post-Adam mobile-decoder
params, must agree at ``tests/test_torch_train_step.py``'s tolerances."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.config import Mode as JMode
from mdn_sfm_tpu.data.synthetic import synthetic_batch
from mdn_sfm_tpu.masks.providers import PrecomputedMaskProvider as JPrecomputed
from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.masks import PrecomputedMaskProvider
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

B, H, W = 2, 64, 96
STEPS = 2
STEPS_PER_EPOCH = 10
LOSS_RTOL = (1e-5, 3e-5)   # tests/test_torch_train_step.py
# grad_norm, steps 0 and 1. At step 0 both packages' DS gradients agree with
# float64 (tests/torch_grad_probe.py): against the port's float64 norm
# 13.9374607, the port's f32 step is 7.8e-8 off and the JAX step's f32
# gradients, summed in float64, 4.5e-7. The norm the JAX step itself reports,
# its f32 sum of 3.2M squares inside the jitted step on the CPU, is
# 13.9373055: 1.11e-5 off. The bound is about twice that; step 1 keeps 3e-5.
GRAD_NORM_RTOL = (2.5e-5, 3e-5)
PARAM_ATOL = 2e-5
NOISE_FLOOR_SHARE = 1e-4
LR = 1e-4
KEYS = ["a", "b"]


def _write_masks(d: str) -> None:
    """Two instance unions: an ellipse at the training size, and blocks at
    half size that the providers resize (fractional edges)."""
    ys, xs = np.mgrid[0:H, 0:W]
    Image.fromarray(((((ys - 30) / 14.0) ** 2 + ((xs - 40) / 25.0) ** 2 <= 1) * 255).astype(np.uint8),
                    mode="L").save(os.path.join(d, "a.png"))
    half = np.zeros((H // 2, W // 2), np.uint8)
    half[4:14, 6:20] = 255
    half[18:28, 30:44] = 9
    Image.fromarray(half, mode="L").save(os.path.join(d, "b.png"))


@pytest.fixture(scope="module", params=["DS", "DC"])
def runs(request, tmp_path_factory):
    mask_dir = str(tmp_path_factory.mktemp("masks"))
    _write_masks(mask_dir)
    kw = dict(height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.05, compute_dtype="float32",
              disable_augment=True, mask_provider="precomputed", mask_dir=mask_dir,
              ds_similarity_term=request.param == "DS")
    colors, K = synthetic_batch(B, H, W, seed=0)
    masks = JPrecomputed(mask_dir).union_masks(KEYS, H, W)
    tmasks = PrecomputedMaskProvider(mask_dir).union_masks(KEYS, H, W)
    np.testing.assert_array_equal(tmasks, masks)
    assert 0 < masks.mean() < 1 and ((masks > 0) & (masks < 1)).any()

    jcfg = JConfig(mode=JMode(request.param), donate_state=False, **kw).validate()
    models = JT.build_models(jcfg)
    variables = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
    tx = JT.make_optimizer(jcfg, STEPS_PER_EPOCH)
    state, frozen = JT.create_train_state(jcfg, models, variables, tx)
    step = JT.make_train_step(jcfg, models, tx)
    jbatch = {"colors_u8": colors, "K": K, "instance_mask": jnp.asarray(masks)}
    jmetrics = []
    for _ in range(STEPS):
        state, frozen, m, _ = step(state, frozen, jbatch, jax.random.PRNGKey(1))
        jmetrics.append({k: float(v) for k, v in m.items()})
    jparams = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(state.params["mobile_decoder"])})

    cfg = Config(mode=Mode(request.param), **kw).validate()
    tmodels = TT.build_models(cfg, device="cpu")
    for net, module in zip(("flownet", "posenet", "mobile_decoder"), tmodels):
        module.load_state_dict(state_dict_from_flax(net, variables[net]), strict=True)
    opt = TT.make_optimizer(cfg, tmodels, STEPS_PER_EPOCH)
    tbatch = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K),
              "instance_mask": torch.from_numpy(tmasks)}
    tmetrics = [{k: float(v) for k, v in TT.train_step(cfg, tmodels, opt, tbatch)[0].items()}
                for _ in range(STEPS)]
    return jmetrics, tmetrics, jparams, tmodels.mobile.state_dict()


@pytest.mark.parametrize("step", range(STEPS))
def test_metrics_match_jax(runs, step):
    jm, tm, _, _ = runs
    assert set(tm[step]) == set(jm[step])
    for k in jm[step]:
        assert np.isfinite(tm[step][k]), k
        rtol = (GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL)[step]
        np.testing.assert_allclose(tm[step][k], jm[step][k], rtol=rtol, err_msg=k)


def test_post_adam_params_match_jax(runs):
    _, _, jparams, tparams = runs
    assert set(jparams) == set(tparams)
    diff = np.concatenate([np.abs(tparams[k].numpy() - v.numpy()).ravel() for k, v in jparams.items()])
    assert diff.max() <= 2 * LR * STEPS
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE
