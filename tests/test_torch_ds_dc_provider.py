"""The port's live Mask R-CNN provider against the JAX package's on the CPU,
both on the crafted brightness detector of ``tests/fixtures.py`` (the same
weights: the JAX tree, and the port's detectron2 ``.pth`` made from it by
``weights.maskrcnn_state_dict_from_flax``), at 64×96 training with
``d2_infer_scale=2`` (128×192 inference), on street scenes.

Both providers run their networks and ROIAlign in bf16, and bf16 rounds at
other places in the two frameworks (the JAX provider also blends its ROI
taps in bf16; the port accumulates them in f32), so the masks are compared
by union IoU, as ``tests/test_precompute_masks.py`` compares its uint8 and
f32 pipelines, and the pixels where they differ must lie on an object's
boundary."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdn_sfm_tpu.masks.maskrcnn as M
from fixtures import craft_brightness_detector, make_street_scene
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.config import Mode as JMode
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider
from mdn_sfm_tpu_torch.weights import maskrcnn_state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

H, W = 64, 96
SEEDS = (0, 1, 2, 3)
# union IoU of the two bf16 providers' masks, per image (measured 0.977-1.0
# on these scenes; the bound leaves room for a few boundary pixels more)
UNION_IOU_MIN = 0.9


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


@pytest.fixture(scope="module")
def masks(tmp_path_factory):
    kw = dict(height=H, width=W, batch_size=len(SEEDS), mask_provider="maskrcnn", d2_max_instances=8,
              d2_infer_scale=2)
    shapes = jax.eval_shape(M.MaskRCNN(max_det=8).init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                            jnp.array(64.0), jnp.array(64.0))
    crafted = craft_brightness_detector(shapes)
    imgs = np.stack([make_street_scene(h=H, w=W, n_objects=2, seed=s)[0] for s in SEEDS])

    jprov = M.MaskRCNNProvider(JConfig(mode=JMode.DS, d2_allow_random_weights=True, **kw).validate())
    jprov.variables = jax.tree.map(jnp.asarray, crafted)
    want = np.asarray(jprov.union_masks_from_images(imgs, H, W))

    log_dir = str(tmp_path_factory.mktemp("log"))
    torch.save(maskrcnn_state_dict_from_flax(crafted), os.path.join(log_dir, "model_final_detectron2.pth"))
    prov = MaskRCNNProvider(Config(mode=Mode.DS, log_dir=log_dir, **kw).validate(), device="cpu")
    got = prov.union_masks_from_images(imgs, H, W).numpy()
    return got, want


def test_masks_are_binary_and_shaped(masks):
    got, want = masks
    assert got.shape == want.shape == (len(SEEDS), H, W) and got.dtype == np.float32
    assert set(np.unique(got)) <= {0.0, 1.0}


@pytest.mark.parametrize("image", range(len(SEEDS)))
def test_union_iou_against_jax_provider(masks, image):
    got, want = masks[0][image] > 0.5, masks[1][image] > 0.5
    assert want.any() and got.any(), "empty masks: the comparison would be vacuous"
    assert _iou(got, want) >= UNION_IOU_MIN
    # a differing pixel has a neighbour inside the union of both masks and
    # one outside it: it lies on an object's boundary
    union = np.pad(got | want, 1)
    inter = np.pad(got & want, 1)
    ys, xs = np.nonzero(got ^ want)
    for y, x in zip(ys + 1, xs + 1):
        assert union[y - 1:y + 2, x - 1:x + 2].any() and not inter[y - 1:y + 2, x - 1:x + 2].all()
