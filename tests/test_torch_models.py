"""The PyTorch port's networks against the Flax models: the same variables,
converted with ``weights.state_dict_from_flax`` and loaded with
``strict=True``, must give the same forward on the same inputs — through
both the JAX package's packed (TPU lane-packed) and unpacked decoder paths,
which the port's plain convolutions stand in for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import checkpoints as ckpt
from mdn_sfm_tpu import models as jm
from mdn_sfm_tpu_torch import models as tm
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

H, W, B = 64, 96, 2
# f32 on both sides; a ResNet18 + decoder accumulates ~1e-5-scale drift from
# summation order (the bound tests/test_torch_parity.py uses)
ATOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    a = rng.normal(scale=0.5, size=(B, H, W, 3)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(B, H, W, 3)).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def flax_vars(imgs):
    """Flax variables of the three nets, pulled to numpy; random BN stats so
    eval-mode BN is not the identity."""
    img = jnp.zeros((1, H, W, 3))
    flow = jm.FlowNet(dtype=jnp.float32, packed=False)
    pose = jm.PoseNet(dtype=jnp.float32)
    fv = jax.device_get(flow.init(jax.random.PRNGKey(0), img, img))
    pv = jax.device_get(pose.init(jax.random.PRNGKey(1), img, img))
    rng = np.random.default_rng(7)

    def jitter_stats(v):
        stats = jax.tree.map(lambda x: np.asarray(x), v["batch_stats"])
        stats = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.uniform(0.5, 1.5, x.shape) if p[-1].key == "var"
                          else rng.normal(scale=0.1, size=x.shape)).astype(np.float32),
            stats,
        )
        return {"params": v["params"], "batch_stats": stats}

    fv, pv = jitter_stats(fv), jitter_stats(pv)
    a, b = imgs
    _, feats = flow.apply(fv, jnp.asarray(a), jnp.asarray(b))
    aa = jnp.zeros((B, 1, 1, 3))
    mv = jax.device_get(jm.MobileDecoder(dtype=jnp.float32, packed=False).init(jax.random.PRNGKey(3), feats, aa, aa))
    return {"flownet": fv, "posenet": pv, "mobile_decoder": mv}


def _port(net: str, variables):
    model = {"flownet": tm.FlowNet, "posenet": tm.PoseNet, "mobile_decoder": tm.MobileDecoder}[net]()
    model.load_state_dict(state_dict_from_flax(net, variables), strict=True)
    return model.eval()


@pytest.mark.parametrize("net", ["flownet", "posenet", "mobile_decoder"])
def test_keys_equal_export_pth(net, flax_vars, tmp_path):
    """The converted keys are exactly checkpoints.export_pth's, and exactly
    the port module's state dict."""
    path = tmp_path / f"{net}.pth"
    ckpt.export_pth(str(path), net, flax_vars[net])
    exported = torch.load(path, weights_only=False)
    converted = state_dict_from_flax(net, flax_vars[net])
    assert set(converted) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(converted[k].numpy(), v.numpy(), err_msg=k)
    assert set(_port(net, flax_vars[net]).state_dict()) == set(converted)


@pytest.mark.parametrize("packed", [True, False])
def test_flownet_forward(packed, flax_vars, imgs):
    a, b = imgs
    flows, feats = jm.FlowNet(dtype=jnp.float32, packed=packed).apply(
        flax_vars["flownet"], jnp.asarray(a), jnp.asarray(b)
    )
    with torch.no_grad():
        tflows, tfeats = _port("flownet", flax_vars["flownet"])(_nchw(a), _nchw(b))
    assert sorted(tflows) == [0, 1, 2, 3]
    for s in range(4):
        assert tflows[s].dtype == torch.float32
        np.testing.assert_allclose(_nhwc(tflows[s]), np.asarray(flows[s]), atol=ATOL, err_msg=f"flow {s}")
    assert [f.shape[1] for f in tfeats] == [16, 32, 64, 128, 256, 512]
    for i, (f, tf) in enumerate(zip(feats, tfeats)):
        np.testing.assert_allclose(_nhwc(tf), np.asarray(f), atol=ATOL, err_msg=f"feature {i}")


def test_posenet_forward(flax_vars, imgs):
    a, b = imgs
    aa, t = jm.PoseNet(dtype=jnp.float32).apply(flax_vars["posenet"], jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        taa, tt = _port("posenet", flax_vars["posenet"])(_nchw(a), _nchw(b))
    assert taa.shape == (B, 1, 1, 3) and tt.shape == (B, 1, 1, 3)
    np.testing.assert_allclose(taa.numpy(), np.asarray(aa), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t), atol=ATOL)


@pytest.mark.parametrize("packed", [True, False])
def test_mobile_decoder_forward(packed, flax_vars, imgs):
    a, b = imgs
    _, feats = jm.FlowNet(dtype=jnp.float32, packed=False).apply(
        flax_vars["flownet"], jnp.asarray(a), jnp.asarray(b)
    )
    rng = np.random.default_rng(2)
    aa = rng.normal(scale=0.01, size=(B, 1, 1, 3)).astype(np.float32)
    t = rng.normal(scale=0.01, size=(B, 1, 1, 3)).astype(np.float32)
    mobiles = jm.MobileDecoder(dtype=jnp.float32, packed=packed).apply(
        flax_vars["mobile_decoder"], feats, jnp.asarray(aa), jnp.asarray(t)
    )
    with torch.no_grad():
        touts = _port("mobile_decoder", flax_vars["mobile_decoder"])(
            [_nchw(f) for f in feats], torch.from_numpy(aa), torch.from_numpy(t)
        )
    for s in range(4):
        assert touts[s].shape == (B, 1, H >> s, W >> s)
        np.testing.assert_allclose(_nhwc(touts[s]), np.asarray(mobiles[s]), atol=ATOL, err_msg=f"mobile {s}")


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_depths_pyramid(depth, imgs):
    """Basic and bottleneck trunks give the 5-level pyramid the decoders need."""
    enc = tm.ResNetEncoder(depth).eval()
    enc.init_weights(torch.Generator().manual_seed(0))
    a, b = imgs
    with torch.no_grad():
        feats = enc(torch.cat([_nchw(a), _nchw(b)], 1))
    assert [f.shape[1] for f in feats] == list(enc.num_ch_enc)
    assert [f.shape[2] for f in feats] == [H // 2, H // 4, H // 8, H // 16, H // 32]
    assert all(torch.isfinite(f).all() for f in feats)
