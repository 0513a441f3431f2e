"""Cross-framework forward parity: Flax model → export_pth → independent
PyTorch twin (tests/torch_twins.py, built from the reference architecture
spec) must produce equal forwards at fp32. This converts "the layer
definitions look the same" into a numeric guarantee, and doubles as a
round-trip test of checkpoints.export_pth's key mapping."""

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mdn_sfm_tpu import checkpoints as ckpt  # noqa: E402
from mdn_sfm_tpu.models import FlowNet, MobileDecoder, PoseNet  # noqa: E402

H, W, B = 64, 96, 2
ATOL = 1e-4  # fp32; a full resnet18 + decoder accumulates ~1e-5-scale drift


def _load_twin(twin, sd_path):
    sd = torch.load(sd_path, weights_only=False)
    missing, unexpected = twin.load_state_dict(sd, strict=False)
    assert not unexpected, f"exported keys the twin doesn't know: {unexpected[:5]}"
    real_missing = [k for k in missing if "num_batches_tracked" not in k]
    assert not real_missing, f"twin params the export didn't fill: {real_missing[:5]}"
    twin.eval()
    return twin


def _nchw(x):
    return torch.from_numpy(np.asarray(x).transpose(0, 3, 1, 2))


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    a = rng.normal(scale=0.5, size=(B, H, W, 3)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(B, H, W, 3)).astype(np.float32)
    return a, b


class TestFlowNetParity:
    @pytest.fixture(scope="class")
    def pair(self, tmp_path_factory):
        from torch_twins import FlowNetTwin

        model = FlowNet(num_layers=18, dtype=jnp.float32)
        img = jnp.zeros((1, H, W, 3))
        variables = model.init(jax.random.PRNGKey(0), img, img)
        path = tmp_path_factory.mktemp("pth") / "flownet.pth"
        ckpt.export_pth(str(path), "flownet", variables)
        twin = _load_twin(FlowNetTwin(), str(path))
        return model, variables, twin

    def test_forward_equal(self, pair, imgs):
        model, variables, twin = pair
        a, b = imgs
        flows, feats = model.apply(variables, jnp.asarray(a), jnp.asarray(b))
        with torch.no_grad():
            tflows, tfeats = twin(_nchw(a), _nchw(b))
        for s in range(4):
            np.testing.assert_allclose(
                np.asarray(flows[s]),
                tflows[s].numpy().transpose(0, 2, 3, 1),
                atol=ATOL,
                err_msg=f"flow scale {s}",
            )
        assert len(feats) == len(tfeats) == 6
        for i, (f, tf) in enumerate(zip(feats, tfeats)):
            np.testing.assert_allclose(
                np.asarray(f), tf.numpy().transpose(0, 2, 3, 1), atol=ATOL,
                err_msg=f"decoder feature {i}",
            )

    def test_pth_reimport_roundtrip(self, pair, tmp_path):
        """export_pth → import_pth lands back on the identical flax tree."""
        model, variables, _ = pair
        path = tmp_path / "flownet.pth"
        ckpt.export_pth(str(path), "flownet", variables)
        loaded = ckpt.import_pth(str(path), "flownet")
        merged = ckpt.merge_partial(jax.device_get(variables), loaded)
        for x, y in zip(jax.tree.leaves(variables), jax.tree.leaves(merged)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestPoseNetParity:
    def test_forward_equal(self, tmp_path, imgs):
        from torch_twins import PoseNetTwin

        model = PoseNet(num_layers=18, dtype=jnp.float32)
        img = jnp.zeros((1, H, W, 3))
        variables = model.init(jax.random.PRNGKey(1), img, img)
        path = tmp_path / "posenet.pth"
        ckpt.export_pth(str(path), "posenet", variables)
        twin = _load_twin(PoseNetTwin(), str(path))

        a, b = imgs
        aa, t = model.apply(variables, jnp.asarray(a), jnp.asarray(b))
        with torch.no_grad():
            taa, tt = twin(_nchw(a), _nchw(b))
        np.testing.assert_allclose(np.asarray(aa), taa.numpy(), atol=ATOL)
        np.testing.assert_allclose(np.asarray(t), tt.numpy(), atol=ATOL)


class TestMobileDecoderParity:
    def test_forward_equal(self, tmp_path, imgs):
        from torch_twins import MobileDecoderTwin

        flow = FlowNet(num_layers=18, dtype=jnp.float32)
        img = jnp.zeros((1, H, W, 3))
        fvars = flow.init(jax.random.PRNGKey(0), img, img)
        a, b = imgs
        _, feats = flow.apply(fvars, jnp.asarray(a), jnp.asarray(b))

        model = MobileDecoder(dtype=jnp.float32)
        rng = np.random.default_rng(2)
        aa = jnp.asarray(rng.normal(scale=0.01, size=(B, 1, 1, 3)).astype(np.float32))
        t = jnp.asarray(rng.normal(scale=0.01, size=(B, 1, 1, 3)).astype(np.float32))
        variables = model.init(jax.random.PRNGKey(3), feats, aa, t)
        path = tmp_path / "mobile_decoder.pth"
        ckpt.export_pth(str(path), "mobile_decoder", variables)
        twin = _load_twin(MobileDecoderTwin(), str(path))

        mobiles = model.apply(variables, feats, aa, t)
        tfeats = [_nchw(f) for f in feats]
        with torch.no_grad():
            touts = twin(
                tfeats,
                torch.from_numpy(np.asarray(aa)),
                torch.from_numpy(np.asarray(t)),
            )
        for s in range(4):
            np.testing.assert_allclose(
                np.asarray(mobiles[s]),
                touts[s].numpy().transpose(0, 2, 3, 1),
                atol=ATOL,
                err_msg=f"mobile scale {s}",
            )
