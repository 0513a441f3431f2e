"""The port's on-device augmentation against ``mdn_sfm_tpu.data.augment``.

torch's generators cannot reproduce ``jax.random``, so the test re-derives
the JAX package's per-sample draws with its own scheme — sample key
``fold_in(rng, offset + i)``, then tags 0 (flip), 1 (scale) and 2 (offset)
— and feeds them to the port explicitly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.data.augment import augment_batch as j_augment
from mdn_sfm_tpu.data.synthetic import synthetic_batch as j_synthetic
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.data import augment_batch, draw_augment, synthetic_batch

B, H, W = 3, 64, 96
# f32 resampling products on both sides (the JAX einsum at full f32 on the
# CPU); pixel values are O(1) after normalization
ATOL = RTOL = 1e-5


def jax_draws(rng, b, h, w, offset=0):
    """The JAX package's draws (data/augment.py), re-derived per sample."""
    keys = [jax.random.fold_in(rng, offset + i) for i in range(b)]
    flip = np.array([bool(jax.random.bernoulli(jax.random.fold_in(k, 0), 0.5)) for k in keys])
    scale = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (2,), minval=1.0, maxval=1.15))
                      for k in keys])
    u = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 2), (2,))) for k in keys])
    max_off = np.stack([w * scale[:, 0] - w, h * scale[:, 1] - h], -1).astype(np.float32)
    return {"flip": torch.from_numpy(flip), "scale_xy": torch.from_numpy(scale),
            "offset_xy": torch.from_numpy((u * max_off).astype(np.float32))}


@pytest.fixture(scope="module")
def batch():
    colors, K = synthetic_batch(B, H, W, seed=3)
    jc, jK = j_synthetic(B, H, W, seed=3)
    np.testing.assert_array_equal(colors, jc)  # the port's own copy, same bytes
    np.testing.assert_array_equal(K, jK)
    return colors, K


def _compare(cfg_kw, batch, rng_seed, train=True):
    colors, K = batch
    rng = jax.random.PRNGKey(rng_seed)
    jcolors, jinv, jraw = j_augment(JConfig(**cfg_kw), jnp.asarray(colors), jnp.asarray(K), rng, train=train)
    draws = jax_draws(rng, B, H, W)
    tcolors, tinv, traw = augment_batch(Config(**cfg_kw), torch.from_numpy(colors), torch.from_numpy(K),
                                        draws=draws, train=train)
    assert set(tcolors) == set(jcolors) and set(tinv) == set(jinv)
    for k in jcolors:
        np.testing.assert_allclose(tcolors[k].numpy(), np.asarray(jcolors[k]), atol=ATOL, rtol=RTOL, err_msg=str(k))
    for s in jinv:
        np.testing.assert_allclose(tinv[s].numpy(), np.asarray(jinv[s]), atol=1e-6, rtol=RTOL, err_msg=f"inv_K {s}")
    np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), atol=ATOL, rtol=RTOL)
    return draws


@pytest.mark.parametrize("seed", [0, 1])
def test_train_augment_matches_jax(batch, seed):
    draws = _compare(dict(height=H, width=W), batch, seed)
    assert draws["scale_xy"].min() >= 1.0 and draws["scale_xy"].max() < 1.15


def test_both_flip_branches_covered(batch):
    flips = torch.cat([jax_draws(jax.random.PRNGKey(s), B, H, W)["flip"] for s in (0, 1)])
    assert flips.any() and not flips.all()


@pytest.mark.parametrize("kw,train", [(dict(disable_augment=True), True), (dict(scales=(0, 1)), False)])
def test_no_augment_paths_match_jax(batch, kw, train):
    """disable_augment in training, and eval (train=False) normalization."""
    _compare(dict(height=H, width=W, **kw), batch, 0, train=train)


def test_disable_augment_is_identity(batch):
    colors, K = batch
    cfg = Config(height=H, width=W, disable_augment=True)
    out, inv, raw = augment_batch(cfg, torch.from_numpy(colors), torch.from_numpy(K))
    np.testing.assert_allclose(raw.numpy(), colors[:, 0] / 255.0, atol=1e-7)
    assert out[(0, 3)].shape == (B, H // 8, W // 8, 3)


def test_generator_draws_in_range():
    g = torch.Generator().manual_seed(0)
    d = draw_augment(64, H, W, g)
    assert d["flip"].dtype == torch.bool
    assert (d["scale_xy"] >= 1).all() and (d["scale_xy"] < 1.15).all()
    max_off = torch.stack([W * d["scale_xy"][:, 0] - W, H * d["scale_xy"][:, 1] - H], -1)
    assert (d["offset_xy"] >= 0).all() and (d["offset_xy"] <= max_off).all()
