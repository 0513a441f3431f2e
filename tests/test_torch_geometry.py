"""Every geometry function of the PyTorch port against its JAX counterpart,
on the same numpy inputs, in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import geometry as jg
from mdn_sfm_tpu_torch import geometry as tg
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

# f32 on both sides with the same formulas; differences are summation order
# and transcendental rounding, a few ulp of values of order 1-100
RTOL = ATOL = 1e-5
B, H, W = 2, 64, 96


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def _K(h=H, w=W):
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    K[0, 1] = 0.3  # a skew term, so every entry of the inverse is exercised
    return np.broadcast_to(K, (B, 4, 4)).copy()


def _pose(rng):
    aa = (rng.normal(size=(B, 3)) * 0.05).astype(np.float32)
    t = (rng.normal(size=(B, 3)) * 0.5).astype(np.float32)
    return aa, t


@pytest.mark.parametrize("scale", [0.0, 1e-9, 0.05, 2.0])
def test_rot_from_axisangle(rng, scale):
    aa = (rng.normal(size=(B, 3)) * scale).astype(np.float32)
    _close(tg.rot_from_axisangle(torch.from_numpy(aa)), jg.rot_from_axisangle(jnp.asarray(aa)))


def test_rot_from_axisangle_grad_finite_at_zero():
    aa = torch.zeros(B, 3, requires_grad=True)
    tg.rot_from_axisangle(aa).sum().backward()
    assert torch.isfinite(aa.grad).all()


@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(rng, invert):
    aa, t = _pose(rng)
    got = tg.transformation_from_parameters(torch.from_numpy(aa[:, None, None]), torch.from_numpy(t[:, None, None]), invert)
    want = jg.transformation_from_parameters(jnp.asarray(aa[:, None, None]), jnp.asarray(t[:, None, None]), invert)
    _close(got, want)


def test_pixel_coords_and_scale_factor():
    _close(tg.pixel_coords(H, W), jg.pixel_coords(H, W), atol=0, rtol=0)
    _close(tg.scale_factor(H, W), jg.scale_factor(H, W), atol=0, rtol=0)


def test_skew_and_fundamental_matrix(rng):
    aa, t = _pose(rng)
    _close(tg.skew(torch.from_numpy(t)), jg.skew(jnp.asarray(t)), atol=0, rtol=0)
    R = np.array(jg.rot_from_axisangle(jnp.asarray(aa)))
    inv_K = np.linalg.inv(_K()[:, :3, :3]).astype(np.float32)
    got = tg.fundamental_matrix(*map(torch.from_numpy, (inv_K, R, t)))
    want = jg.fundamental_matrix(*map(jnp.asarray, (inv_K, R, t)))
    # F's entries span ~1e-7 … 1; relative to its largest entry
    _close(got, want, atol=1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("h,w", [(H, W), (37, 83)])
def test_epipolar_residual(rng, h, w):
    aa, t = _pose(rng)
    R = np.array(jg.rot_from_axisangle(jnp.asarray(aa)))
    flow = (rng.normal(size=(B, h, w, 2)) * 3).astype(np.float32)
    inv_K = np.array(jg.invert_intrinsics(jnp.asarray(_K(h, w))))
    args = (flow, inv_K, R, t)
    got = tg.epipolar_residual(*map(torch.from_numpy, args))
    want = np.asarray(jg.epipolar_residual(*map(jnp.asarray, args)))
    # residuals are pixel distances of a few px; abs error relative to the map
    _close(got, want, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [3, 4])
def test_invert_intrinsics(n):
    K = _K()[:, :n, :n]
    got = tg.invert_intrinsics(torch.from_numpy(K))
    _close(got, jg.invert_intrinsics(jnp.asarray(K)))
    np.testing.assert_allclose(got.numpy() @ K, np.broadcast_to(np.eye(n), K.shape), atol=1e-5)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bilinear_sample(rng, padding_mode):
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    # coordinates straddling every border
    coords = np.stack(
        [rng.uniform(-3, W + 2, size=(B, H, W)), rng.uniform(-3, H + 2, size=(B, H, W))], -1
    ).astype(np.float32)
    got = tg.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords), padding_mode)
    want = jg.bilinear_sample(jnp.asarray(img), jnp.asarray(coords), padding_mode)
    _close(got, want)


def test_inverse_warp(rng):
    img = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    flow = (rng.normal(size=(B, H, W, 2)) * 4).astype(np.float32)
    warped, valid = tg.inverse_warp(torch.from_numpy(img), torch.from_numpy(flow))
    jw, jv = jg.inverse_warp(jnp.asarray(img), jnp.asarray(flow))
    _close(warped, jw)
    _close(valid, jv, atol=0, rtol=0)


@pytest.mark.parametrize(
    "shape,out",
    [
        ((B, H, W, 3), (H // 4, W // 4)),   # downsample: no antialias
        ((B, H, W, 1), (H * 2, W * 2)),     # upsample
        ((B, H, W, 1), (H * 2, W // 2)),    # mixed
        ((H, W, 2), (H // 2, W // 3)),      # HWC
        ((H, W), (H // 4, W // 4)),         # HW
    ],
)
def test_resize_bilinear(rng, shape, out):
    x = rng.uniform(size=shape).astype(np.float32)
    got = tg.resize_bilinear(torch.from_numpy(x), *out)
    want = jg.resize_bilinear(jnp.asarray(x), *out)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_upsample_nearest_2x(rng):
    x = rng.normal(size=(B, 8, 12, 5)).astype(np.float32)
    _close(tg.upsample_nearest_2x(torch.from_numpy(x)), jg.upsample_nearest_2x(jnp.asarray(x)), atol=0, rtol=0)


def test_gauss_distance_weight():
    got = tg.gauss_distance_weight(192, 640, 4, 30.0, 120.0)
    want = jg.gauss_distance_weight(192, 640, 4, 30.0, 120.0)
    for g, w in zip(got, want, strict=True):
        _close(g, w, atol=0, rtol=0)
