"""``losses.compute_losses`` of the port against the JAX package's, in all
five modes: the loss dict and the aux maps, from the same numpy inputs. DS
and DC get a numpy instance mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import losses as jl
from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode
from mdn_sfm_tpu.geometry import invert_intrinsics, transformation_from_parameters
from mdn_sfm_tpu_torch import losses as tl
from mdn_sfm_tpu_torch.config import Config, Mode
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

B, H, W = 2, 64, 96
SCALES = (0, 1, 2, 3)
FRAMES = (-1, 1)
# f32 on both sides; the means over up to 6144 pixels and the TG weights
# (values up to ~1e4) bound the drift at a few ulp of each term
RTOL = 1e-5
ATOL = 1e-6
# the maps: near a zero of the residual, (F·p1)·p2 cancels, so its error is
# absolute — a few ulp of the map's largest value
MAP_ATOL = 1e-5


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    colors, flows, mobiles = {}, {}, {}
    for s in SCALES:
        hs, ws = H >> s, W >> s
        for f in (0,) + FRAMES:
            colors[(f, s)] = rng.normal(scale=0.5, size=(B, hs, ws, 3)).astype(np.float32)
        for f in FRAMES:
            # normalized flow of a few pixels
            flows[(f, s)] = (rng.normal(size=(B, hs, ws, 2)) * 3 / np.array([ws, hs])).astype(np.float32)
            mobiles[(f, s)] = rng.uniform(0.01, 0.99, size=(B, hs, ws, 1)).astype(np.float32)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * W, 1.92 * H, W / 2, H / 2
    inv_Ks = {}
    for s in SCALES:
        Ks = K.copy()
        Ks[:2] /= 2**s
        inv_Ks[s] = np.array(invert_intrinsics(jnp.asarray(np.broadcast_to(Ks, (B, 4, 4)))))
    cams = {}
    for f in FRAMES:
        aa = (rng.normal(size=(B, 1, 1, 3)) * 0.02).astype(np.float32)
        t = (rng.normal(size=(B, 1, 1, 3)) * 0.3).astype(np.float32)
        cams[f] = np.array(transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t)))
    mask = np.zeros((B, H, W), np.float32)
    mask[:, 10:30, 20:50] = 1.0  # a binary instance-union mask
    return colors, inv_Ks, flows, mobiles, cams, mask


def _both(inputs, with_mask, **kw):
    colors, inv_Ks, flows, mobiles, cams, mask = inputs
    kw = dict(height=H, width=W, **kw)
    jcfg = JConfig(**{**kw, "mode": JMode(kw["mode"].value)})
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None

    def j(d):
        return {k: jnp.asarray(v) for k, v in d.items()}

    def t(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    want = jl.compute_losses(jcfg, j(colors), j(inv_Ks), j(flows), j(mobiles), j(cams), jm)
    got = tl.compute_losses(Config(**kw), t(colors), t(inv_Ks), t(flows), t(mobiles), t(cams), tm)
    return got, want


def _check(got, want):
    (gl, ga), (wl, wa) = got, want
    assert set(gl) == set(wl)
    for k in wl:
        np.testing.assert_allclose(float(gl[k]), float(wl[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    for name in ("epipolars", "epipolar_ori", "flows", "min_mobiles"):
        g, w = getattr(ga, name), getattr(wa, name)
        assert set(g) == set(w), name
        for k in w:
            wv = np.asarray(w[k])
            np.testing.assert_allclose(
                g[k].numpy(), wv, rtol=RTOL, atol=MAP_ATOL * max(1.0, float(np.abs(wv).max())),
                err_msg=f"{name}{k}",
            )


@pytest.mark.parametrize(
    "mode,with_mask,kw",
    [
        (Mode.SN, False, dict(w_d2_sim=0.0)),
        (Mode.SN, True, dict(w_d2_sim=0.05)),  # the reference's SN+DC head
        (Mode.T, False, dict(threshold=9.22)),
        (Mode.TG, False, dict(threshold=9.22, w_d2_sim=0.0)),  # the main path
        (Mode.DS, True, dict()),
        (Mode.DS, True, dict(ds_similarity_term=True)),
        (Mode.DC, True, dict(w_d2_sim=0.05)),
    ],
)
def test_compute_losses_matches_jax(inputs, mode, with_mask, kw):
    _check(*_both(inputs, with_mask, mode=mode, **kw))


@pytest.mark.parametrize(
    "kw",
    [
        dict(disable_min=True),
        dict(disable_photoloss=False, no_ssim=False),
        dict(disable_consisloss=True, disable_smoothloss=True),
    ],
)
def test_loss_options_match_jax(inputs, kw):
    _check(*_both(inputs, False, mode=Mode.TG, **kw))


@pytest.mark.parametrize("mode", [Mode.DS, Mode.DC])
def test_mask_modes_refuse_missing_mask(inputs, mode):
    colors, inv_Ks, flows, mobiles, cams, _ = inputs

    def t(d):
        return {k: torch.from_numpy(v) for k, v in d.items()}

    with pytest.raises(ValueError, match="requires instance masks"):
        tl.compute_losses(Config(height=H, width=W, mode=mode), t(colors), t(inv_Ks), t(flows),
                          t(mobiles), t(cams), None)


def test_divergence_matches_jax():
    rng = np.random.default_rng(4)
    fg = (rng.uniform(size=(B, 16, 24, 1)) > 0.5).astype(np.float32)
    feat = rng.normal(size=(B, 16, 24, 8)).astype(np.float32)
    got = tl.divergence(torch.from_numpy(fg), torch.from_numpy(feat))
    want = jl.divergence(jnp.asarray(fg), jnp.asarray(feat))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
