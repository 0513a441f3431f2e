"""The port's Mask R-CNN R50-FPN against the JAX package's on the CPU: a JAX
``MaskRCNN``'s variables carried across by ``weights.maskrcnn_state_dict_from_flax``,
float32 on both sides at ``tests/test_maskrcnn.py``'s TestEndToEnd budget
(128×256, max_det 4, top-k 64 / 32 / 64), the port's batched ``Detections``
held against JAX's per image on valid slots at
``tests/test_maskrcnn.py::TestTorchPipelineParity``'s tolerances; and the
detectron2 ``.pth`` import (``tests/torch_d2_twin.py`` serialized) with its
errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdn_sfm_tpu.masks.maskrcnn as M
from fixtures import craft_brightness_detector, make_street_scene
from mdn_sfm_tpu_torch.masks import maskrcnn as TM
from mdn_sfm_tpu_torch.weights import maskrcnn_state_dict_from_flax
from torch_d2_twin import random_twin
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

BUDGET = dict(max_det=4, pre_nms_topk=64, post_nms_topk=32, box_candidates=64)
H, W = 128, 256
TRUE_HW = (120.0, 250.0)
# tests/test_maskrcnn.py:586-591 (JAX against the torch twin, both f32)
SCORE_ATOL, SCORE_RTOL = 5e-4, 1e-3
BOX_ATOL, BOX_RTOL = 0.1, 1e-3
MASK_ATOL = 2e-3


def _jax_variables(weights: str, model) -> dict:
    """'crafted': the brightness detector of tests/fixtures.py (real,
    distinct detections); 'twin': the torch twin's random weights through
    the JAX importer (every box clipped flat, one detection repeated)."""
    if weights == "crafted":
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                                jnp.array(64.0), jnp.array(64.0))
        return craft_brightness_detector(shapes)
    return jax.device_get(M.import_detectron2_state_dict(random_twin(seed=3).state_dict(), model))


def _images(weights: str) -> np.ndarray:
    if weights == "crafted":
        rgb = np.stack([make_street_scene(h=H, w=W, n_objects=2, seed=s)[0] for s in (0, 1)])
        imgs = rgb[..., ::-1].astype(np.float32)
    else:
        imgs = np.random.default_rng(11).uniform(0, 255, size=(2, H, W, 3)).astype(np.float32)
    return imgs - np.array(M.PIXEL_MEAN_BGR, np.float32)


@pytest.fixture(scope="module", params=["crafted", "twin"])
def pair(request):
    score_thresh = M.ROI_SCORE_THRESH if request.param == "crafted" else 0.05
    jmodel = M.MaskRCNN(dtype=jnp.float32, roi_dtype=jnp.float32, score_thresh=score_thresh, **BUDGET)
    variables = _jax_variables(request.param, jmodel)
    imgs = _images(request.param)
    apply = jax.jit(jmodel.apply)
    jdets = [jax.device_get(apply(variables, jnp.asarray(im), jnp.float32(TRUE_HW[0]), jnp.float32(TRUE_HW[1])))
             for im in imgs]
    model = TM.MaskRCNN(dtype=torch.float32, roi_dtype=torch.float32, score_thresh=score_thresh, **BUDGET)
    model.load_state_dict(maskrcnn_state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        det = model.eval()(torch.from_numpy(imgs), *TRUE_HW)
    return request.param, jdets, det


def test_detections_shapes(pair):
    _, _, det = pair
    d = BUDGET["max_det"]
    assert det.boxes.shape == (2, d, 4) and det.scores.shape == (2, d) and det.valid.shape == (2, d)
    assert det.classes.shape == (2, d) and det.classes.dtype == torch.int32
    assert det.masks28.shape == (2, d, TM.MASK_RES, TM.MASK_RES)
    for t in (det.boxes, det.scores, det.masks28):
        assert torch.isfinite(t).all()
    assert (det.boxes[..., [0, 2]] <= TRUE_HW[1]).all() and (det.boxes[..., [1, 3]] <= TRUE_HW[0]).all()


@pytest.mark.parametrize("image", [0, 1])
def test_detections_match_jax_on_valid_slots(pair, image):
    weights, jdets, det = pair
    j = jdets[image]
    np.testing.assert_array_equal(det.valid[image].numpy(), np.asarray(j.valid))
    v = np.asarray(j.valid)
    assert v.any(), "no valid detection: the comparison would be vacuous"
    np.testing.assert_array_equal(det.classes[image].numpy()[v], np.asarray(j.classes)[v])
    np.testing.assert_allclose(det.scores[image].numpy()[v], np.asarray(j.scores)[v], atol=SCORE_ATOL,
                               rtol=SCORE_RTOL)
    np.testing.assert_allclose(det.boxes[image].numpy()[v], np.asarray(j.boxes)[v], atol=BOX_ATOL, rtol=BOX_RTOL)
    np.testing.assert_allclose(det.masks28[image].numpy()[v], np.asarray(j.masks28)[v], atol=MASK_ATOL)
    if weights == "crafted":  # distinct real detections, not one repeated
        assert len({tuple(b) for b in np.asarray(j.boxes)[v].round(2).tolist()}) == v.sum()


def test_state_dict_keys_are_detectron2s():
    model = TM.MaskRCNN(**BUDGET)
    keys = set(model.state_dict())
    assert keys == set(random_twin(seed=0).state_dict())
    for k in ("backbone.bottom_up.stem.conv1.weight", "backbone.bottom_up.res3.2.conv2.norm.running_var",
              "backbone.bottom_up.res2.0.shortcut.weight", "backbone.fpn_lateral2.bias",
              "proposal_generator.rpn_head.anchor_deltas.weight", "roi_heads.box_head.fc1.weight",
              "roi_heads.box_predictor.cls_score.bias", "roi_heads.mask_head.deconv.weight"):
        assert k in keys, k


@pytest.fixture(scope="module")
def twin_pth(tmp_path_factory):
    twin = random_twin(seed=3, max_det=8, pre_nms_topk=64, post_nms_topk=32, box_candidates=64,
                       score_thresh=0.05)
    path = str(tmp_path_factory.mktemp("d2") / "model_final_detectron2.pth")
    sd = dict(twin.state_dict())
    sd["pixel_mean"] = torch.tensor(M.PIXEL_MEAN_BGR).reshape(3, 1, 1)          # ignorable keys
    sd["proposal_generator.anchor_generator.cell_anchors.0"] = torch.zeros(3, 4)
    torch.save({"model": sd}, path)
    return twin, path


def test_twin_pth_imports_strictly(twin_pth):
    twin, path = twin_pth
    model = TM.import_detectron2_pth(path, TM.MaskRCNN(dtype=torch.float32, **BUDGET))
    got = model.state_dict()
    for k, v in twin.state_dict().items():
        assert torch.equal(got[k], v), k


def test_imported_twin_matches_its_forward(twin_pth):
    """The port with the twin's .pth against the twin's own forward (an
    independent torch implementation of the same spec), on valid slots."""
    twin, path = twin_pth
    model = TM.import_detectron2_pth(path, TM.MaskRCNN(dtype=torch.float32, roi_dtype=torch.float32, max_det=8,
                                                       pre_nms_topk=64, post_nms_topk=32, box_candidates=64,
                                                       score_thresh=0.05)).eval()
    img = _images("twin")[0]
    with torch.no_grad():
        det = model(torch.from_numpy(img)[None], *TRUE_HW)
    tb, ts, tc, tm, tv = twin(torch.from_numpy(img).permute(2, 0, 1), *TRUE_HW)
    np.testing.assert_array_equal(det.valid[0].numpy(), tv.numpy())
    v = tv.numpy()
    assert v.any()
    np.testing.assert_array_equal(det.classes[0].numpy()[v], tc.numpy()[v])
    np.testing.assert_allclose(det.scores[0].numpy()[v], ts.numpy()[v], atol=SCORE_ATOL, rtol=SCORE_RTOL)
    np.testing.assert_allclose(det.boxes[0].numpy()[v], tb.numpy()[v], atol=BOX_ATOL, rtol=BOX_RTOL)
    np.testing.assert_allclose(det.masks28[0].numpy()[v], tm.numpy()[v], atol=MASK_ATOL)


def test_unknown_key_raises(twin_pth):
    twin, _ = twin_pth
    sd = dict(twin.state_dict())
    sd["roi_heads.unexpected.weight"] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        TM.import_detectron2_state_dict(sd, TM.MaskRCNN(**BUDGET), strict=True)


def test_missing_leaf_raises(twin_pth):
    twin, _ = twin_pth
    sd = dict(twin.state_dict())
    del sd["roi_heads.mask_head.deconv.weight"]
    with pytest.raises(ValueError, match="unfilled|fills"):
        TM.import_detectron2_state_dict(sd, TM.MaskRCNN(**BUDGET), strict=True)


def test_shape_mismatch_raises(twin_pth):
    twin, _ = twin_pth
    sd = dict(twin.state_dict())
    sd["roi_heads.box_predictor.cls_score.bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="shape mismatch"):
        TM.import_detectron2_state_dict(sd, TM.MaskRCNN(**BUDGET), strict=True)


def test_flax_conversion_inverts_the_jax_importer(twin_pth):
    """detectron2 → JAX importer → maskrcnn_state_dict_from_flax gives the
    detectron2 state dict back, the deconv's flip and the fc transposes
    included."""
    twin, _ = twin_pth
    variables = jax.device_get(M.import_detectron2_state_dict(twin.state_dict(), M.MaskRCNN(**BUDGET)))
    back = maskrcnn_state_dict_from_flax(variables)
    want = twin.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_build_model_and_weights(twin_pth):
    _, path = twin_pth
    model = TM.build_model_and_weights(4, path, fast=True, score_thresh=0.7, roi_dtype=torch.bfloat16, device="cpu")
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    assert (model.pre_nms_topk, model.post_nms_topk, model.box_candidates) == (256, 256, 512)
    assert model.score_thresh == 0.7 and model.roi_dtype == torch.bfloat16 and model.dtype == torch.bfloat16
    rand = TM.build_model_and_weights(4, None, device="cpu")
    assert rand.pre_nms_topk == TM.RPN_PRE_NMS_TOPK and rand.roi_dtype == torch.float32
    assert "roi_dtype" not in TM.FAST_BUDGET
