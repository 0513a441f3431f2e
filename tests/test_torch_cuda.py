"""Tests of the port's CUDA kernels on the card. A CUDA kernel has no
interpret mode, so these skip on a machine without a GPU; run them there
with

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
    from mdn_sfm_tpu_torch.ops.epipolar_cases import epi_inputs

    return list(epi_inputs(b, h, w, seed, nchw_view=True, device=device))


@pytest.mark.parametrize("shape", [(4, 192, 640), (4, 96, 320), (4, 48, 160), (4, 24, 80),
                                   (8, 192, 640), (1, 37, 83), (2, 1, 1)])
def test_epipolar_kernel_matches_plain(card, shape):
    from mdn_sfm_tpu_torch.ops import epipolar as E

    args = _inputs(*shape, seed=sum(shape), device=card)
    n0 = E.epipolar_abs_residual_maps.launches
    got = E.epipolar_abs_residual(*args)
    want = E.epipolar_abs_residual_reference(*args)
    torch.cuda.synchronize()
    assert E.epipolar_abs_residual_maps.launches == n0 + 1
    assert got.shape == shape and got.is_contiguous() and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= REL_TOL * float(want.abs().max())


def test_epipolar_kernel_refuses_grad(card):
    from mdn_sfm_tpu_torch.ops import epipolar as E

    flow, inv_K, R, t = _inputs(1, 8, 8, 0, card)
    with pytest.raises(ValueError, match="no gradient"):
        E.epipolar_abs_residual(flow.detach().requires_grad_(), inv_K, R, t)


@pytest.mark.parametrize("arg,bad,match", [(1, torch.float64, "must be float32"), (2, "cpu", "on one device"),
                                           (3, "cpu", "on one device")])
def test_epipolar_kernel_refuses_pose_off_device_or_not_f32(card, arg, bad, match):
    from mdn_sfm_tpu_torch.ops import epipolar as E

    args = _inputs(1, 8, 8, 0, card)
    args[arg] = args[arg].to(bad)
    n0 = E.epipolar_abs_residual_maps.launches
    with pytest.raises(ValueError, match=match):
        E.epipolar_abs_residual(*args)
    assert E.epipolar_abs_residual_maps.launches == n0


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
    n0 = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps
    m = T.train_step(cfg, models, opt, batch, generator=torch.Generator(device=card).manual_seed(1))
    # one launch computes the step's 8 maps (2 reference frames x 4 scales)
    assert (E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps) == (n0[0] + 1, n0[1] + 8)
    assert all(torch.isfinite(v) for v in m.values())


@pytest.mark.parametrize("layout,vec", [("loss", True), ("dense", True), ("nchw_view", False)])
def test_epipolar_maps_kernel_matches_plain_at_main_path_segments(card, layout, vec):
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import BATCH, HEIGHT, WIDTH, step_maps

    maps = step_maps(layout, BATCH, HEIGHT, WIDTH, seed=0)
    assert all(E.vector_layout(m.flow) is vec for m in maps)
    n0 = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps
    got = E.epipolar_abs_residual_maps(maps)
    want = E.epipolar_abs_residual_maps_reference(maps)
    torch.cuda.synchronize()
    assert (E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps) == (n0[0] + 1, n0[1] + 8)
    assert len({g.untyped_storage().data_ptr() for g in got}) == 1  # views of one buffer
    for g, wnt, m in zip(got, want, maps):
        assert g.shape == m.flow.shape[:3] and torch.isfinite(g).all()
        err = float((g - wnt).abs().max())
        print(f"{layout} {tuple(m.flow.shape)} max_abs_err {err}")
        assert err <= REL_TOL * float(wnt.abs().max())


def test_epipolar_maps_kernel_matches_plain_at_ragged_odd_width(card):
    """Odd W takes the scalar path, even W the vector path, in one launch."""
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import ragged_maps

    maps = ragged_maps(seed=0)
    assert [E.vector_layout(m.flow) for m in maps] == [False, False, False, False, True]
    got = E.epipolar_abs_residual_maps(maps)
    want = E.epipolar_abs_residual_maps_reference(maps)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        err = float((g - wnt).abs().max())
        print(f"ragged {tuple(g.shape)} max_abs_err {err}")
        assert err <= REL_TOL * float(wnt.abs().max())


@pytest.mark.parametrize("cpu_first", [True, False])
def test_epipolar_maps_refuse_a_list_across_devices(card, cpu_first):
    """A CPU map beside a card map raises before any path is chosen: the
    plain version never runs on card tensors."""
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import ragged_maps

    on_card, on_cpu = ragged_maps(seed=0)[:1], ragged_maps(seed=0, device="cpu")[:1]
    n0 = E.epipolar_abs_residual_maps.launches
    with pytest.raises(ValueError, match="on one device"):
        E.epipolar_abs_residual_maps(on_cpu + on_card if cpu_first else on_card + on_cpu)
    assert E.epipolar_abs_residual_maps.launches == n0
