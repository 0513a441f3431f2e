"""The port's live Mask R-CNN provider against the JAX package's at
``d2_infer_scale`` 1 and 4, as ``tests/test_torch_ds_dc_provider.py`` holds
it at 2: both on the crafted brightness detector of ``tests/fixtures.py``
(the JAX tree, and the port's detectron2 ``.pth`` made from it), on street
scenes at a training shape whose inference shape the FPN takes (a multiple
of 64): 128×192 at scale 1 (inference 128×192) and 32×64 at scale 4
(inference 128×256). Both run in bf16, so the union masks are compared by
IoU, and the pixels where they differ must lie on an object's boundary."""

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

SHAPES = {1: (128, 192), 4: (32, 64)}  # d2_infer_scale → training (H, W)
SEEDS = (0, 1, 2, 3)
# union IoU of the two bf16 providers' masks, per image: the bound of
# tests/test_torch_ds_dc_provider.py
UNION_IOU_MIN = 0.9


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    return float((a & b).sum() / max((a | b).sum(), 1))


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    shapes = jax.eval_shape(M.MaskRCNN(max_det=8).init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                            jnp.array(64.0), jnp.array(64.0))
    tree = craft_brightness_detector(shapes)
    log_dir = str(tmp_path_factory.mktemp("log"))
    torch.save(maskrcnn_state_dict_from_flax(tree), os.path.join(log_dir, "model_final_detectron2.pth"))
    return tree, log_dir


@pytest.fixture(scope="module", params=sorted(SHAPES), ids=lambda s: f"scale{s}")
def masks(request, crafted):
    scale = request.param
    h, w = SHAPES[scale]
    tree, log_dir = crafted
    kw = dict(height=h, width=w, batch_size=len(SEEDS), mask_provider="maskrcnn", d2_max_instances=8,
              d2_infer_scale=scale)
    imgs = np.stack([make_street_scene(h=h, w=w, n_objects=2, seed=s)[0] for s in SEEDS])
    jprov = M.MaskRCNNProvider(JConfig(mode=JMode.DS, d2_allow_random_weights=True, **kw).validate())
    jprov.variables = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jprov.union_masks_from_images(imgs, h, w))
    prov = MaskRCNNProvider(Config(mode=Mode.DS, log_dir=log_dir, **kw).validate(), device="cpu")
    assert prov.infer_hw == (h * scale, w * scale)
    got = prov.union_masks_from_images(imgs, h, w).numpy()
    return scale, got, want


def test_masks_are_binary_and_shaped(masks):
    scale, got, want = masks
    assert got.shape == want.shape == (len(SEEDS),) + SHAPES[scale] and got.dtype == np.float32
    assert set(np.unique(got)) <= {0.0, 1.0}


@pytest.mark.parametrize("image", range(len(SEEDS)))
def test_union_iou_against_jax_provider(masks, image):
    _, got, want = masks
    got, want = got[image] > 0.5, want[image] > 0.5
    assert want.any() and got.any(), "empty masks: the comparison would be vacuous"
    assert _iou(got, want) >= UNION_IOU_MIN
    # a differing pixel has a neighbour inside the union of both masks and
    # one outside it: it lies on an object's boundary
    union = np.pad(got | want, 1)
    inter = np.pad(got & want, 1)
    ys, xs = np.nonzero(got ^ want)
    for y, x in zip(ys + 1, xs + 1):
        assert union[y - 1:y + 2, x - 1:x + 2].any() and not inter[y - 1:y + 2, x - 1:x + 2].all()
