"""The JAX package's other configurations in the port, held against JAX on
the CPU: the pose net at the deeper encoder depths (``--num_layers`` 34, 50,
101 and 152; the bottleneck trunk from 50), its weights carried by the
port's converter and by ``.pth`` files both ways, ``Config()``'s defaults
field by field, and the NMS kernel's box limit against the most boxes the
Mask R-CNN's proposal budgets can hand it at ``d2_infer_scale`` 4.

The variables are made from each depth's shapes with numpy (a jitted JAX
init of a 152-layer trunk takes half a minute on one core): kaiming-normal
kernels, BN statistics drawn away from the identity, and the last BN of each
residual branch scaled to 0.05-0.15, so that 50 blocks in eval mode keep the
activations of order one and a fixed tolerance means the same at every
depth."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import checkpoints as JC
from mdn_sfm_tpu import models as jm
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu_torch import checkpoints as ckpt
from mdn_sfm_tpu_torch import models as tm
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.masks import maskrcnn as TM
from mdn_sfm_tpu_torch.ops.nms import MAX_BOXES
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

H, W, B = 64, 96, 2
DEPTHS = (34, 50, 101, 152)
# f32 on both sides, summed in another order: tests/test_torch_parity.py's bound
ATOL = 1e-4
STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    return tuple(rng.normal(scale=0.5, size=(B, H, W, 3)).astype(np.float32) for _ in range(2))


def pose_variables(depth: int) -> dict:
    """The JAX PoseNet's variables at ``depth``, numpy, from its shapes."""
    img = jnp.zeros((1, H, W, 3))
    shapes = jax.eval_shape(jm.PoseNet(num_layers=depth, dtype=jnp.float32).init, jax.random.PRNGKey(0), img, img)
    rng = np.random.default_rng(depth)
    last_bn = "bn3" if depth > 34 else "bn2"

    def leaf(path, s):
        names = [p.key for p in path]
        if names[-1] == "kernel":
            fan_out = s.shape[0] * s.shape[1] * s.shape[-1]
            return rng.normal(scale=np.sqrt(2.0 / fan_out), size=s.shape).astype(np.float32)
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if names[-1] in ("mean", "bias"):
            return rng.normal(scale=0.1, size=s.shape).astype(np.float32)
        lo, hi = (0.05, 0.15) if names[-2] == last_bn else (0.5, 1.5)
        return rng.uniform(lo, hi, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _encoder_vars(v: dict) -> dict:
    return {"params": v["params"]["encoder"], "batch_stats": v["batch_stats"]["encoder"]}


@pytest.mark.parametrize("depth", DEPTHS)
def test_posenet_forward_matches_jax(depth, imgs):
    """The trunk's 5-level pyramid and the pose at each depth, from the
    same variables carried by ``weights.state_dict_from_flax`` into the
    port's PoseNet (``strict=True``)."""
    a, b = imgs
    v = pose_variables(depth)
    x = jnp.concatenate([jnp.asarray(a), jnp.asarray(b)], -1)
    enc = jm.ResNetEncoder(num_layers=depth, num_input_images=2, dtype=jnp.float32)
    feats = jax.jit(lambda v, x: enc.apply(v, x))(_encoder_vars(v), x)
    aa, t = jax.jit(jm.PoseNet(num_layers=depth, dtype=jnp.float32).apply)(v, jnp.asarray(a), jnp.asarray(b))

    model = tm.PoseNet(num_layers=depth)
    model.load_state_dict(state_dict_from_flax("posenet", v), strict=True)
    model.eval()
    assert model.encoder.num_ch_enc == enc.num_ch_enc
    assert model.decoder.pose_net[0].in_channels == enc.num_ch_enc[-1]
    with torch.no_grad():
        tfeats = model.encoder(torch.cat([_nchw(a), _nchw(b)], 1))
        taa, tt = model(_nchw(a), _nchw(b))
    assert [f.shape[1] for f in tfeats] == list(enc.num_ch_enc)
    for i, (f, tf) in enumerate(zip(feats, tfeats)):
        assert 0.1 < float(np.abs(np.asarray(f)).max()) < 100.0, "activations out of the range the bound is for"
        np.testing.assert_allclose(_nhwc(tf), np.asarray(f), atol=ATOL, err_msg=f"depth {depth} feature {i}")
    np.testing.assert_allclose(taa.numpy(), np.asarray(aa), atol=ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t), atol=ATOL)


@pytest.mark.parametrize("depth", (34, 50))
def test_bottleneck_and_basic_block_layout(depth):
    """Each stage's first block downsamples (a 1×1 conv and BN on the skip),
    the bottleneck strides its 3×3 (torchvision's placement, the JAX
    package's ``stride_in_1x1=False``) and widens ×4."""
    trunk = tm.PoseNet(num_layers=depth).encoder.encoder
    for stage, n_blocks in enumerate(STAGES[depth]):
        blocks = list(getattr(trunk, f"layer{stage + 1}"))
        assert len(blocks) == n_blocks
        stride = 1 if stage == 0 else 2
        first = blocks[0]
        if depth > 34:
            assert (first.conv1.stride, first.conv2.stride, first.conv3.stride) == ((1, 1), (stride, stride), (1, 1))
            assert first.conv3.out_channels == 4 * first.conv1.out_channels
            assert first.downsample is not None  # the ×4 widening needs the skip projected, stage 1 too
        else:
            assert first.conv1.stride == (stride, stride)
            assert (first.downsample is not None) == (stage > 0)
        assert first.downsample is None or first.downsample[0].stride == (stride, stride)
        assert all(blk.downsample is None for blk in blocks[1:])


def test_posenet_50_pth_both_ways(tmp_path):
    """A 50-layer ``posenet.pth`` written by the port's checkpoint writer is
    read by the JAX package's ``import_pth`` into exactly the variables it
    came from, and those come back into the port's state dict exactly."""
    v = pose_variables(50)
    sd = state_dict_from_flax("posenet", v)
    model = tm.PoseNet(num_layers=50)
    model.load_state_dict(sd, strict=True)
    folder = str(tmp_path / "weights_0")
    ckpt.save_checkpoint(folder, {"posenet": model.state_dict()}, step=3)
    jv = JC.import_pth(os.path.join(folder, "posenet.pth"), "posenet")
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(jv)[0])
    assert set(got) == set(want)
    for k, arr in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), arr, err_msg=jax.tree_util.keystr(k))
    back = state_dict_from_flax("posenet", jv)
    assert set(back) == set(model.state_dict())
    for k, t in model.state_dict().items():
        assert torch.equal(back[k], t), k
    loaded = tm.PoseNet(num_layers=50)
    assert ckpt.load_into(folder, {"posenet": loaded}, ("posenet",)) == 3
    for k, t in loaded.state_dict().items():
        assert torch.equal(t, sd[k]), k


@pytest.mark.parametrize("depth", (18, 34, 50))
def test_jax_export_pth_drops_blocks_past_the_third(depth, tmp_path):
    """The JAX package's ``export_pth`` names blocks 0-2 of each stage only
    (``mdn_sfm_tpu/checkpoints.py:354``), so from 34 layers on its
    ``posenet.pth`` lacks layer2.3 and layer3.3-5 and no strict load takes
    it; the port's converter names every block. What it does write equals
    the port's converter exactly, and what it drops is exactly those blocks
    (the JAX package stays as it is; the README converts with the port's
    ``state_dict_from_flax``)."""
    v = pose_variables(depth)
    path = str(tmp_path / "posenet.pth")
    JC.export_pth(path, "posenet", v)
    exported = torch.load(path, weights_only=True)
    converted = state_dict_from_flax("posenet", v)
    dropped = {k for k in converted if k.startswith("encoder.encoder.layer") and int(k.split(".")[3]) >= 3}
    assert set(exported) == set(converted) - dropped
    assert bool(dropped) == (depth > 18)
    for k, t in exported.items():
        assert torch.equal(t, converted[k]), k
    missing, unexpected = tm.PoseNet(num_layers=depth).load_state_dict(exported, strict=False)
    assert set(missing) == dropped and not unexpected


def test_config_defaults_equal_jax():
    """Every field the two Configs share has the same default (both have the
    same fields), so ``Config()`` is the same run in both packages."""
    jf = {f.name for f in dataclasses.fields(JConfig)}
    tf = {f.name for f in dataclasses.fields(Config)}
    assert jf == tf
    j, t = JConfig(), Config()
    for name in sorted(jf):
        jv, tv = getattr(j, name), getattr(t, name)
        if name == "mode":
            jv, tv = jv.value, tv.value
        assert type(jv) is type(tv) and jv == tv, name
    assert (t.height, t.width, t.batch_size, t.num_layers, t.mode.value) == (128, 416, 4, 18, "SN")


@pytest.mark.parametrize("fast", [True, False], ids=["fast_budget", "full_budget"])
def test_nms_box_limit_covers_each_budget_at_scale_4(fast, monkeypatch):
    """The boxes each NMS call takes a image at ``d2_infer_scale`` 4 on the
    main path's 192×640 (768×2560 inference), for the provider's fast
    budget and the backend's full one: the Mask R-CNN's forward runs on the
    FPN levels' shapes with the backbone's outputs stubbed (zeros: every
    score ties, so every budget fills), and each count must sit within the
    NMS kernel's MAX_BOXES, past which its wrapper raises."""
    scale, (h, w) = 4, (192, 640)
    ih, iw = h * scale, w * scale
    model = TM.MaskRCNN(max_det=32, **(TM.FAST_BUDGET if fast else {})).eval()
    levels = [torch.zeros(1, 256, ih // s, iw // s) for s in (4, 8, 16, 32, 64)]

    class Levels(torch.nn.Module):
        def forward(self, x):
            return levels

    model.backbone = Levels()
    counts = []
    real_nms = TM.nms

    def counting_nms(boxes, scores, thresh, max_out):
        counts.append(boxes.shape[1])
        return real_nms(boxes, scores, thresh, max_out)

    monkeypatch.setattr(TM, "nms", counting_nms)
    with torch.no_grad():
        model(torch.zeros(1, ih, iw, 3), float(ih), float(iw))
    budget = TM.FAST_BUDGET if fast else dict(pre_nms_topk=TM.RPN_PRE_NMS_TOPK, post_nms_topk=TM.RPN_POST_NMS_TOPK,
                                               box_candidates=model.box_candidates)
    rpn = 5 * budget["pre_nms_topk"]  # each of P2-P6 holds more anchors than the top-k at this shape
    classes = min(budget["box_candidates"], budget["post_nms_topk"] * TM.NUM_CLASSES)
    assert counts == [rpn, classes]
    assert max(counts) <= MAX_BOXES
