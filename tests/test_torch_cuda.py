"""Tests of the port's CUDA kernels on the card. A CUDA kernel has no
interpret mode, so these skip on a machine without a GPU; run them there with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# the kernel is built with --fmad=false and rounds op by op as the plain
# version does; a few ulp of the map's largest value
REL_TOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (a CUDA kernel has no CPU mode)")
    from mdn_sfm_tpu_torch.ops import _build

    _build.build_all()
    return torch.device("cuda")


def _inputs(b, h, w, seed, device):
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_intrinsics
    from mdn_sfm_tpu_torch.geometry import invert_intrinsics, rot_from_axisangle

    g = torch.Generator().manual_seed(seed)
    flow = 3.0 * torch.randn(b, 2, h, w, generator=g)
    K = torch.from_numpy(synthetic_intrinsics(h, w)).expand(b, 4, 4)
    R = rot_from_axisangle(0.01 * torch.randn(b, 3, generator=g))
    t = torch.tensor([0.0, 0.0, 0.8]) + 0.05 * torch.randn(b, 3, generator=g)
    return [x.to(device) for x in (flow.permute(0, 2, 3, 1), invert_intrinsics(K), R, t)]


@pytest.mark.parametrize("shape", [(4, 192, 640), (4, 96, 320), (4, 48, 160), (4, 24, 80),
                                   (8, 192, 640), (1, 37, 83), (2, 1, 1)])
def test_epipolar_kernel_matches_plain(card, shape):
    from mdn_sfm_tpu_torch.ops import epipolar as E

    args = _inputs(*shape, seed=sum(shape), device=card)
    n0 = E.epipolar_abs_residual.launches
    got = E.epipolar_abs_residual(*args)
    want = E.epipolar_abs_residual_reference(*args)
    torch.cuda.synchronize()
    assert E.epipolar_abs_residual.launches == n0 + 1
    assert got.shape == shape and got.is_contiguous() and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())


def test_epipolar_kernel_refuses_grad(card):
    from mdn_sfm_tpu_torch.ops import epipolar as E

    flow, inv_K, R, t = _inputs(1, 8, 8, 0, card)
    with pytest.raises(ValueError, match="no gradient"):
        E.epipolar_abs_residual(flow.detach().requires_grad_(), inv_K, R, t)


@pytest.mark.parametrize("arg,bad", [(1, torch.float64), (2, "cpu"), (3, "cpu")])
def test_epipolar_kernel_refuses_pose_off_device_or_not_f32(card, arg, bad):
    from mdn_sfm_tpu_torch.ops import epipolar as E

    args = _inputs(1, 8, 8, 0, card)
    args[arg] = args[arg].to(bad)
    n0 = E.epipolar_abs_residual.launches
    with pytest.raises(ValueError, match="must be float32 on cuda"):
        E.epipolar_abs_residual(*args)
    assert E.epipolar_abs_residual.launches == n0


def test_train_step_launches_kernel_8_times(card):
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
    from mdn_sfm_tpu_torch.ops import epipolar as E

    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0).validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), card)
    opt = T.make_optimizer(cfg, models, 10)
    colors, K = synthetic_batch(2, 64, 96, seed=0)
    batch = {"colors_u8": torch.from_numpy(colors).to(card), "K": torch.from_numpy(K).to(card)}
    n0 = E.epipolar_abs_residual.launches
    m = T.train_step(cfg, models, opt, batch, generator=torch.Generator(device=card).manual_seed(1))
    assert E.epipolar_abs_residual.launches == n0 + 8
    assert all(torch.isfinite(v) for v in m.values())
