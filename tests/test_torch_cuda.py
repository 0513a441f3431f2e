"""Tests of the port's CUDA kernels on the card. A CUDA kernel has no
interpret mode, so these skip on a machine without a GPU; run them there
with

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

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
    m, _ = T.train_step(cfg, models, opt, batch, generator=T.step_generator(cfg.seed, 0, card))
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


@pytest.mark.parametrize("cli,n_maps", [("mix", 1), ("flow", 2)])
def test_eval_batch_maps_one_launch_match_plain(card, cli, n_maps):
    """An eval batch at the main path's width (B = 8, 192×640): evaluate_mix's
    one map, and evaluate_flow's two in one launch (the nets' normalized flow
    beside the GT's pixel flow with the stereo baseline as pose)."""
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops.epipolar_cases import EVAL_BATCH, HEIGHT, WIDTH, eval_maps

    maps = eval_maps(cli, EVAL_BATCH, HEIGHT, WIDTH, seed=3)
    assert [m.scale for m in maps] == [(WIDTH, HEIGHT), (1.0, 1.0)][:n_maps]
    n0 = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps
    got = E.epipolar_abs_residual_maps(maps)
    want = E.epipolar_abs_residual_maps_reference(maps)
    torch.cuda.synchronize()
    assert (E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps) == (n0[0] + 1, n0[1] + n_maps)
    for g, wnt in zip(got, want):
        assert g.shape == (EVAL_BATCH, HEIGHT, WIDTH) and torch.isfinite(g).all()
        err = float((g - wnt).abs().max())
        print(f"eval {cli} {tuple(g.shape)} max_abs_err {err}")
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


# ------------------------------------------------ the Mask R-CNN's kernels


def _nms_inputs(n_img, n, seed, device):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(n_img, n, 2, generator=g) * 400
    boxes = torch.cat([xy, xy + 1 + torch.rand(n_img, n, 2, generator=g) * 80], -1)
    scores = torch.randn(n_img, n, generator=g)
    scores = torch.where(scores > 0.3, scores, torch.zeros(()))  # ties at 0
    scores[-1, : n // 2] = float("-inf")
    if n > 3:
        boxes[0, 3, 2] = boxes[0, 3, 0]                           # a box with no area
        scores[0, 3] = 10.0
    return boxes.to(device), scores.to(device)


@pytest.mark.parametrize("n_img,n,max_out,thresh", [(4, 1280, 256, 0.7), (4, 512, 32, 0.5), (1, 5000, 1000, 0.7),
                                                    (2, 8192, 64, 0.7), (3, 1, 4, 0.5)])
def test_nms_kernel_equals_plain(card, n_img, n, max_out, thresh):
    from mdn_sfm_tpu_torch.ops import nms as N

    boxes, scores = _nms_inputs(n_img, n, seed=n, device=card)
    n0 = N.nms.launches
    keep, valid = N.nms(boxes, scores, thresh, max_out)
    want_k, want_v = N.nms_reference(boxes, scores, thresh, max_out)
    torch.cuda.synchronize()
    assert N.nms.launches == n0 + 1
    assert torch.equal(keep, want_k) and torch.equal(valid, want_v)
    with pytest.raises(ValueError, match="boxes an image"):
        N.nms(torch.zeros(1, N.MAX_BOXES + 1, 4, device=card), torch.zeros(1, N.MAX_BOXES + 1, device=card), 0.5, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_box,out_size", [(256, 7), (32, 14)])
def test_roi_align_kernel_equals_plain(card, dtype, n_box, out_size):
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    g = torch.Generator().manual_seed(n_box)
    feats = [torch.randn(4, h, w, 256, generator=g).to(card, dtype) for h, w in ((96, 320), (48, 160), (24, 80), (12, 40))]
    xy = torch.rand(4, n_box, 2, generator=g) * torch.tensor([1280.0, 384.0])
    boxes = torch.cat([xy, xy + torch.exp(torch.rand(4, n_box, 2, generator=g) * 6)], -1)
    boxes[0, :3] = torch.tensor([[0.0, 0.0, 224.0, 224.0], [5.0, 5.0, 117.0, 117.0], [0.0, 0.0, 0.0, 0.0]])
    boxes = boxes.to(card)
    n0 = RA.multilevel_roi_align.launches
    got = RA.multilevel_roi_align(feats, boxes, out_size)
    want = RA.roi_align_reference(feats, boxes, out_size)
    torch.cuda.synchronize()
    assert RA.multilevel_roi_align.launches == n0 + 1 and got.dtype == dtype
    tol = (1e-6 if dtype == torch.float32 else 2.0**-8) * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_fused_ds_step_launches_each_kernel(card, tmp_path):
    """A fused DS step at 64×96 on the card: 1 epipolar launch (8 maps), 2
    NMS and 2 ROIAlign launches."""
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.DS, mask_provider="maskrcnn",
                 d2_allow_random_weights=True, d2_score_thresh=0.05, log_dir=str(tmp_path)).validate()
    provider = MaskRCNNProvider(cfg, card)
    models = T.build_models(cfg, torch.Generator().manual_seed(0), card)
    opt = T.make_optimizer(cfg, models, 10)
    colors, K = synthetic_batch(2, 64, 96, seed=0)
    batch = {"colors_u8": torch.from_numpy(colors).to(card), "K": torch.from_numpy(K).to(card)}
    counts = (E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps, N.nms.launches,
              RA.multilevel_roi_align.launches)
    metrics, _ = T.train_step(cfg, models, opt, batch, generator=T.step_generator(0, 0, card), provider=provider)
    torch.cuda.synchronize()
    after = (E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps, N.nms.launches,
             RA.multilevel_roi_align.launches)
    assert [a - b for a, b in zip(after, counts)] == [1, 8, 2, 2]
    assert torch.isfinite(metrics["loss"])


# ------------------------------------- the step options and IEEE divisions


def _small_batch(card, b=2, h=64, w=96, seed=0):
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    colors, K = synthetic_batch(b, h, w, seed=seed)
    return {"colors_u8": torch.from_numpy(colors).to(card), "K": torch.from_numpy(K).to(card)}


@pytest.mark.parametrize("train", [True, False])
def test_augment_and_post_processing_equal_the_cpu_bitwise(card, train):
    """augment_batch (train with the same draws, and eval) and the TG and T
    post-processing on the card equal the CPU's bit for bit: every division
    by a constant is an IEEE division on both (``utils.divisor``)."""
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.augment import augment_batch, draw_augment, eval_preprocess
    from mdn_sfm_tpu_torch.geometry import gauss_distance_weight
    from mdn_sfm_tpu_torch.losses import post_process_epipolar

    cfg = Config(height=192, width=640, batch_size=4, mode=Mode.TG, threshold=9.22).validate()
    batch = _small_batch("cpu", 4, 192, 640, seed=1)
    draws = draw_augment(4, 192, 640, torch.Generator().manual_seed(2)) if train else None
    out = {}
    for dev in ("cpu", card):
        colors, inv_Ks, raw0 = augment_batch(cfg, batch["colors_u8"].to(dev), batch["K"].to(dev), draws=draws,
                                             train=train)
        resid = colors[(0, 0)][..., :1].abs() * 7.0  # a map of the loss's shape and range
        gw = gauss_distance_weight(192, 640, 1, cfg.gauss_sigma1, cfg.gauss_sigma2, dev)[0]
        out[dev] = [*colors.values(), *inv_Ks.values(), raw0, eval_preprocess(batch["colors_u8"].to(dev)),
                    *post_process_epipolar(Mode.TG, resid, threshold=9.22, gauss_weight=gw),
                    *post_process_epipolar(Mode.T, resid, threshold=9.22)]
    for i, (a, b) in enumerate(zip(out["cpu"], out[card])):
        assert torch.equal(a, b.cpu()), (i, float((a - b.cpu()).abs().max()))


def test_fine_tune_step_takes_the_plain_map_with_no_launch(card):
    """fine_tune_flow_motion: the step's maps are the plain version with
    autograd, no kernel launch; on the same inputs they equal the kernel's
    maps, and so do the losses."""
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.data.augment import augment_batch
    from mdn_sfm_tpu_torch.losses import compute_losses
    from mdn_sfm_tpu_torch.ops import epipolar as E

    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                 fine_tune_flow_motion=True, compute_dtype="float32").validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), card)
    opt = T.make_optimizer(cfg, models, 10)
    n0 = E.epipolar_abs_residual_maps.launches
    m, _ = T.train_step(cfg, models, opt, _small_batch(card), generator=T.step_generator(0, 0, card))
    torch.cuda.synchronize()
    assert E.epipolar_abs_residual_maps.launches == n0 and torch.isfinite(m["loss"])

    batch = _small_batch(card)
    colors, inv_Ks, _ = augment_batch(cfg, batch["colors_u8"], batch["K"], train=False)
    with torch.no_grad():
        f, mob, _, _, cam = T.forward_frame(cfg, models, colors[(0, 0)], colors[(1, 0)])
    flows = {(i, s): f[s] for i in cfg.ref_frame_ids for s in cfg.scales}
    mobiles = {(i, s): mob[s] for i in cfg.ref_frame_ids for s in cfg.scales}
    cams = {i: cam for i in cfg.ref_frame_ids}
    plain, plain_aux = compute_losses(cfg, colors, inv_Ks, flows, mobiles, cams)
    assert E.epipolar_abs_residual_maps.launches == n0
    frozen = dataclasses.replace(cfg, fine_tune_flow_motion=False)
    kern, kern_aux = compute_losses(frozen, colors, inv_Ks, flows, mobiles, cams)
    torch.cuda.synchronize()
    assert E.epipolar_abs_residual_maps.launches == n0 + 1
    for key, v in plain_aux.epipolar_ori.items():
        assert float((v - kern_aux.epipolar_ori[key]).abs().max()) <= REL_TOL * float(v.abs().max())
    for k, v in plain.items():
        assert abs(float(v) - float(kern[k])) <= REL_TOL * abs(float(v)), k


def test_bn_train_step_launches_the_kernel_once_for_8_maps(card):
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.ops import epipolar as E

    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                 bn_frozen_eval=False).validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), card)
    before = models.flow.encoder.encoder.bn1.running_mean.clone()
    opt = T.make_optimizer(cfg, models, 10)
    n0 = E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps
    m, _ = T.train_step(cfg, models, opt, _small_batch(card), generator=T.step_generator(0, 0, card))
    torch.cuda.synchronize()
    assert (E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps) == (n0[0] + 1, n0[1] + 8)
    assert torch.isfinite(m["loss"]) and not torch.equal(before, models.flow.encoder.encoder.bn1.running_mean)


def test_skipped_step_leaves_the_state_as_it_was(card):
    """skip_nonfinite_updates on the card: a step with a NaN intrinsic
    changes no param, μ, ν or count, bit for bit; the next step applies."""
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode

    cfg = Config(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                 skip_nonfinite_updates=True).validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), card)
    opt = T.make_optimizer(cfg, models, 10)
    T.train_step(cfg, models, opt, _small_batch(card), generator=T.step_generator(0, 0, card))
    before = [t.clone() for t in [p.detach() for p in opt.params] + opt.mu + opt.nu]
    bad = _small_batch(card, seed=1)
    bad["K"][0, 0, 0] = float("nan")
    T.train_step(cfg, models, opt, bad, generator=T.step_generator(0, 1, card))
    after = [p.detach() for p in opt.params] + opt.mu + opt.nu
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert (opt.count, int(opt.notfinite_count), int(opt.total_notfinite)) == (1, 1, 1)
    T.train_step(cfg, models, opt, _small_batch(card, seed=2), generator=T.step_generator(0, 2, card))
    assert opt.count == 2 and int(opt.notfinite_count) == 0
