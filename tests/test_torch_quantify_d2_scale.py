"""The port's ``quantify_d2_scale`` against the same composition of the JAX
package's backend and providers (``tools/quantify_d2_scale.py``'s loop), on
the crafted brightness detector, at the setup of
``tests/test_maskrcnn.py::TestInferScaleDeviation``: 64×128 training,
128×256 street scenes, max_det 8, the fast backend at a 128×256 input, the
providers at scales 1 and 2, two scenes. About 45 s on one worker.

Both sides run the same weights: JAX's crafted tree, and the port's own
crafted state dict (``masks.crafted``), which equals
``weights.maskrcnn_state_dict_from_flax`` of that tree
(``tests/test_torch_rehearsal.py``). The JAX backend and providers are
built with ``MaskRCNN.init`` returning the crafted tree: the tool discards
their random init for it, and the init forward alone takes a minute here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mdn_sfm_tpu.masks.maskrcnn as M
from fixtures import craft_brightness_detector, make_street_scene
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.config import Mode as JMode
from mdn_sfm_tpu.geometry import resize_bilinear
from mdn_sfm_tpu_torch import quantify_d2_scale as Q
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

H, W = 64, 128
SCENE_HW = (128, 256)
MAX_DET = 8
SCALES = (1, 2)
N_IMAGES = 2
# each IoU within this of JAX's row: the rows were measured equal to 4
# decimals but scene 1's scale-2 IoU, 0.964 against 0.8971 (the bf16
# providers round at other places in the two frameworks; the port's union
# lies nearer the backend's), and the bound is about twice that gap
IOU_ATOL = 0.14
# the summary's keys, as the JAX tool prints them
SUMMARY_KEYS = {"metric", "n_images", "mean_backend_iou_vs_gt", "mean_n_backend", "mean_iou_scale1",
                "mean_n_scale1", "mean_iou_scale2", "mean_n_scale2"}


def jax_rows() -> list[dict]:
    """tools/quantify_d2_scale.py's loop, at the small setup."""
    import cv2

    shapes = jax.eval_shape(M.MaskRCNN(max_det=MAX_DET).init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                            jnp.array(64.0), jnp.array(64.0))
    crafted = jax.tree.map(jnp.asarray, craft_brightness_detector(shapes))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M.MaskRCNN, "init", lambda self, *a, **k: crafted)
        backend = M.MaskRCNNBackend(max_det=MAX_DET, fast=True, input_hw=SCENE_HW)
        providers = {}
        for s in SCALES:
            cfg = JConfig(height=H, width=W, mode=JMode.DS, mask_provider="maskrcnn", d2_max_instances=MAX_DET,
                          d2_infer_scale=s, d2_allow_random_weights=True).validate()
            providers[s] = M.MaskRCNNProvider(cfg)
    backend.variables = crafted
    for prov in providers.values():
        prov.variables = crafted

    def provider_count(prov, img_u8, scale):
        # the JAX tool's own copy of the provider's preprocessing
        ih, iw = H * scale, W * scale
        x = resize_bilinear(jnp.asarray(img_u8, jnp.float32)[None], ih, iw)[0]
        x = x[..., ::-1] - jnp.asarray(M.PIXEL_MEAN_BGR, jnp.float32)
        det = jax.jit(prov.model.apply)(prov.variables, x, jnp.float32(ih), jnp.float32(iw))
        return int(jax.device_get(det.valid).sum())

    rows = []
    for i in range(N_IMAGES):
        img, gt = make_street_scene(h=SCENE_HW[0], w=SCENE_HW[1], n_objects=Q.N_OBJECTS, seed=i)
        masks, _b, _c, _s = backend.predict(img)
        union_full = masks.any(axis=0).astype(np.float32)
        ref = cv2.resize(union_full, (W, H), interpolation=cv2.INTER_AREA) > 0.5
        gt_small = cv2.resize(gt.astype(np.float32), (W, H), interpolation=cv2.INTER_AREA) > 0.5
        row = {"image": i, "n_backend": masks.shape[0], "backend_iou_vs_gt": Q._iou(ref, gt_small)}
        for s, prov in providers.items():
            u = np.asarray(prov.union_masks_from_images(img[None], H, W))[0] > 0.5
            row[f"iou_s{s}"] = Q._iou(u, ref)
            row[f"n_s{s}"] = provider_count(prov, img, s)
        rows.append(row)
    return rows


@pytest.fixture(scope="module")
def rows():
    got, summary = Q.quantify(N_IMAGES, SCALES, H, W, MAX_DET, scene_hw=SCENE_HW, input_hw=SCENE_HW, fast=True,
                              device="cpu")
    return got, summary, jax_rows()


@pytest.mark.parametrize("image", range(N_IMAGES))
def test_counts_equal_jax(rows, image):
    """The backend's detections and each provider's, counted through the
    preprocessing its union masks go through, equal the JAX tool's."""
    got, want = rows[0][image], rows[2][image]
    assert got["n_backend"] > 0, "the backend found nothing: the comparison would be vacuous"
    for key in ("image", "n_backend", *(f"n_s{s}" for s in SCALES)):
        assert got[key] == want[key], key


@pytest.mark.parametrize("image", range(N_IMAGES))
def test_ious_within_bound_of_jax(rows, image):
    got, want = rows[0][image], rows[2][image]
    assert set(got) == set(want)
    for key in ("backend_iou_vs_gt", *(f"iou_s{s}" for s in SCALES)):
        assert abs(got[key] - want[key]) <= IOU_ATOL, (key, got[key], want[key])


def test_summary_keys_means_and_ordering(rows):
    got, summary, want = rows
    assert set(summary) == SUMMARY_KEYS and summary["n_images"] == N_IMAGES
    for s in SCALES:
        assert summary[f"mean_iou_scale{s}"] == round(float(np.mean([r[f"iou_s{s}"] for r in got])), 4)
        assert summary[f"mean_n_scale{s}"] == round(float(np.mean([r[f"n_s{s}"] for r in got])), 2)
    # scale 2 sees the backend's pixels, scale 1 half of them: in both packages
    assert summary["mean_iou_scale2"] > summary["mean_iou_scale1"]
    assert np.mean([r["iou_s2"] for r in want]) > np.mean([r["iou_s1"] for r in want])
