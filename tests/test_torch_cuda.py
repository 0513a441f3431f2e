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


def _nms_adversarial(kind, n_img, n, seed, device):
    """Boxes and scores that test the kernel's sort, count and scan: NaN
    scores and corners, -inf, -0.0 ties, duplicates, a box without area."""
    boxes, scores = _nms_inputs(n_img, n, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    pick = int(torch.randint(n, (1,), generator=g))
    if kind == "nan_score":
        scores[0, pick] = float("nan")
    elif kind == "nan_corners_top":
        boxes[0, 2, 1] = float("nan")
        scores[0, 2] = 100.0
    elif kind == "nan_corners":
        boxes[:, pick, 2] = float("nan")
    elif kind == "all_neg_inf":
        scores[:] = float("-inf")
    elif kind == "neg_zero":
        scores[:, ::3] = -0.0
    elif kind == "duplicates":
        boxes[:, n // 2:] = boxes[:, : n - n // 2]
        scores[:, n // 2:] = scores[:, : n - n // 2]
    return boxes.to(device), scores.to(device)


@pytest.mark.parametrize("kind", ["nan_score", "nan_corners_top", "nan_corners", "all_neg_inf", "neg_zero",
                                  "duplicates"])
@pytest.mark.parametrize("n_img,n,max_out,thresh", [(2, 300, 100, 0.5), (4, 1280, 256, 0.7), (1, 8192, 1000, 0.7),
                                                    (2, 31, 40, 0.5), (2, 33, 40, 0.5)])
def test_nms_kernel_adversarial_equals_plain(card, kind, n_img, n, max_out, thresh):
    """keep and valid identical to the plain version on inputs that end the
    run early, suppress everything, tie by index, or repeat boxes; max_out
    past n included."""
    from mdn_sfm_tpu_torch.ops import nms as N

    boxes, scores = _nms_adversarial(kind, n_img, n, seed=n + max_out, device=card)
    keep, valid = N.nms(boxes, scores, thresh, max_out)
    want_k, want_v = N.nms_reference(boxes, scores, thresh, max_out)
    torch.cuda.synchronize()
    assert torch.equal(keep, want_k) and torch.equal(valid, want_v)
    if kind in ("nan_score", "all_neg_inf"):
        assert not valid[0].any()


def _roi_inputs(card, dtype, n_box, channels, seed):
    """P2..P5 of a 384×1280 input and boxes over all four levels, past the
    image's edges and of zero size."""
    g = torch.Generator().manual_seed(seed)
    hw = ((96, 320), (48, 160), (24, 80), (12, 40))
    feats = [torch.randn(4, h, w, channels, generator=g).to(card, dtype) for h, w in hw]
    xy = torch.rand(4, n_box, 2, generator=g) * torch.tensor([1400.0, 460.0]) - torch.tensor([60.0, 40.0])
    boxes = torch.cat([xy, xy + torch.exp(torch.rand(4, n_box, 2, generator=g) * 6.5)], -1)
    boxes[0, :6] = torch.tensor([[0.0, 0.0, 40.0, 40.0],         # P2
                                 [5.0, 5.0, 229.0, 229.0],       # P4
                                 [0.0, 0.0, 150.0, 150.0],       # P3
                                 [-50.0, -30.0, 1330.0, 420.0],  # P5, past every edge
                                 [7.0, 9.0, 7.0, 9.0],           # zero size
                                 [1270.0, 380.0, 1500.0, 500.0]])  # past the far edges
    return feats, boxes.to(card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_box,out_size,channels", [(256, 7, 256), (32, 14, 256), (64, 7, 100), (16, 14, 100),
                                                     (64, 7, 3), (16, 14, 3)])
def test_roi_align_kernel_equals_plain(card, dtype, n_box, out_size, channels):
    """Exactly the plain version's output (the kernel rounds op by op as it
    does): the 16-byte vector path at C = 256 and the scalar path at C = 100
    and 3, each level, clipped taps and a zero-size box."""
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    feats, boxes = _roi_inputs(card, dtype, n_box, channels, seed=n_box + channels)
    assert set(RA.assign_fpn_level(boxes).flatten().tolist()) == {2, 3, 4, 5}
    n0 = RA.multilevel_roi_align.launches
    got = RA.multilevel_roi_align(feats, boxes, out_size)
    want = RA.roi_align_reference(feats, boxes, out_size)
    torch.cuda.synchronize()
    assert RA.multilevel_roi_align.launches == n0 + 1 and got.dtype == dtype
    assert torch.equal(got, want)


def test_roi_align_kernel_unaligned_level_takes_scalar_path(card):
    """A level that starts 4 bytes off a 16-byte boundary: the same kernel
    reads it a channel at a time, exactly."""
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    feats, boxes = _roi_inputs(card, torch.float32, 64, 256, seed=5)
    shifted = torch.empty(feats[1].numel() + 1, device=card)[1:].view(feats[1].shape)
    shifted.copy_(feats[1])
    feats[1] = shifted
    assert shifted.data_ptr() % 16 == 4
    got = RA.multilevel_roi_align(feats, boxes, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, RA.roi_align_reference(feats, boxes, 7))


def test_nms_kernel_takes_more_images_than_a_short_grid_axis(card):
    """More images than a grid's y or z axis holds (65535): the three NMS
    kernels put the batch on x, and the result equals the plain version."""
    from mdn_sfm_tpu_torch.ops import nms as N

    n_img = 70000
    g = torch.Generator().manual_seed(5)
    xy = torch.rand(n_img, 3, 2, generator=g) * 20
    boxes = torch.cat([xy, xy + 1 + torch.rand(n_img, 3, 2, generator=g) * 10], -1).to(card)
    scores = torch.randn(n_img, 3, generator=g).to(card)
    keep, valid = N.nms(boxes, scores, 0.5, 2)
    ref_keep, ref_valid = N.nms_reference(boxes, scores, 0.5, 2)
    assert torch.equal(keep, ref_keep) and torch.equal(valid, ref_valid)


def test_roi_align_kernel_levels_past_2_31_elements(card):
    """A level of three images, 2^30 bf16 elements each: the last image's
    base lies past 2^31 elements (the kernel adds it in 64 bits), and the
    kernel equals the plain version on boxes in every image."""
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    g = torch.Generator(device=card).manual_seed(6)
    feats = [torch.randn(3, h, h, 256, generator=g, device=card, dtype=torch.bfloat16)
             for h in (2048, 16, 8, 4)]
    assert 2 * feats[0][0].numel() >= 2**31  # the third image's base
    xy = torch.rand(3, 64, 2, generator=g, device=card) * 8000
    boxes = torch.cat([xy, xy + 4 + torch.rand(3, 64, 2, generator=g, device=card) * 100], -1)  # P2
    boxes[:, -4:] = torch.tensor([[0.0, 0.0, 300.0, 300.0], [10.0, 10.0, 600.0, 500.0],
                                  [0.0, 0.0, 8192.0, 8192.0], [8100.0, 8100.0, 8192.0, 8192.0]], device=card)
    got = RA.multilevel_roi_align(feats, boxes, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, RA.roi_align_reference(feats, boxes, 7))


def test_roi_align_kernel_refuses_what_it_cannot_index(card):
    """A CUDA tensor the ROIAlign kernel does not take raises rather than
    falling back: more samples a side than its shared tables hold, or none."""
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    feats, boxes = _roi_inputs(card, torch.float32, 8, 8, seed=0)
    with pytest.raises(ValueError, match="samples a side"):
        RA.multilevel_roi_align(feats, boxes, RA.MAX_SAMPLES // 2 + 1)
    with pytest.raises(ValueError, match="samples a side"):
        RA.multilevel_roi_align(feats, boxes, 7, sampling=0)


def test_mask_kernels_capture_in_a_graph(card):
    """NMS (its three device kernels and their scratch) and ROIAlign captured
    in one CUDA graph, replayed twice on new inputs copied into the static
    ones, equal their eager calls; the counters count the capture's calls."""
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    boxes, scores = _nms_inputs(4, 1280, seed=3, device=card)
    feats, rboxes = _roi_inputs(card, torch.bfloat16, 256, 256, seed=3)
    N.nms(boxes, scores, 0.7, 256)  # warm: the first call configures the sort's shared memory
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        RA.multilevel_roi_align(feats, rboxes, 7)
        with torch.cuda.graph(graph):
            keep, valid = N.nms(boxes, scores, 0.7, 256)
            pooled = RA.multilevel_roi_align(feats, rboxes, 7)
    torch.cuda.current_stream().wait_stream(side)
    for seed in (11, 12):
        b2, s2 = _nms_inputs(4, 1280, seed=seed, device=card)
        f2, r2 = _roi_inputs(card, torch.bfloat16, 256, 256, seed=seed)
        boxes.copy_(b2), scores.copy_(s2), rboxes.copy_(r2)
        for f, g in zip(feats, f2):
            f.copy_(g)
        graph.replay()
        want_k, want_v = N.nms(b2, s2, 0.7, 256)
        want_p = RA.multilevel_roi_align(f2, r2, 7)
        torch.cuda.synchronize()
        assert torch.equal(keep, want_k) and torch.equal(valid, want_v) and torch.equal(pooled, want_p)
        assert valid.any()


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


# --------------------------- K steps a dispatch, as one captured CUDA graph


def _dispatch_bundles(card, k=3, n=2, tmp_path=None, **kw):
    """``n`` bundles of the same nets and Adam (one for a K-step graph
    dispatch, the others for K eager steps), the K batches and their draws."""
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.config import Config, Mode
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNProvider

    base = dict(height=64, width=96, batch_size=2, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                compute_dtype="float32")
    if kw.get("mode") == "DS":
        base.update(mask_provider="maskrcnn", d2_allow_random_weights=True, d2_score_thresh=0.05,
                    log_dir=str(tmp_path))
    cfg = Config(**{**base, **kw}).validate()
    provider = MaskRCNNProvider(cfg, card) if cfg.mask_provider == "maskrcnn" else None
    bundles = []
    for _ in range(n):
        models = T.build_models(cfg, torch.Generator().manual_seed(0), card)
        bundles.append((models, T.make_optimizer(cfg, models, 10)))
    steps = [_small_batch(card, seed=s) for s in range(k)]
    batches = {key: torch.stack([b[key] for b in steps]) for key in steps[0]}
    return cfg, provider, bundles, batches, T.multi_step_draws(cfg, batches, 0)


@pytest.mark.parametrize("options", [{}, {"compute_dtype": "bfloat16"},
                                     {"fine_tune_flow_motion": True, "remat": True},
                                     {"bn_frozen_eval": False, "accum_steps": 2, "skip_nonfinite_updates": True},
                                     {"mode": "DS"}],
                         ids=["tg", "tg_bf16", "fine_tune_remat", "bn_train_accum_skip", "ds_fused"])
def test_graph_dispatch_equals_eager_steps(card, tmp_path, options):
    """A K = 3 dispatch, one replay of a graph captured over 3 steps, against
    four runs of 3 eager steps from the same state on the same batches and
    draws. Step 0's losses are equal bit for bit (no atomics run before its
    backward). After it runs differ: the reflection pads' backward adds with
    atomics (in bf16 at bf16's precision), a gradient at that noise flips the
    sign of Adam's update, and the eager runs of one process may share
    roundings that the graph does not. The rest lie within twice the largest
    gap between the eager runs or a floor: in f32 1e-4 relative per Adam
    update taken (the fine-tune step, whose flow and pose params flip too,
    came 4.2e-5 to 8.7e-5 from eager runs at step 2 on an H100, while one
    update moves its epip by 0.94 and the next by 0.48 of its value), in
    bf16 0.1, where eager runs spread 1.6 % (consis at step 1). The params
    move at most 2·lr a step apart, and the share past 2e-5 stays within
    twice the eager runs' largest share, or 1e-4. With bf16 the graph casts
    the weights anew at every step: a replayed stale cast would give step 1
    the losses of the step-0 weights (consis 0.052 against 0.00032 after the
    first update)."""
    from mdn_sfm_tpu_torch import training as T

    cfg, provider, bundles, batches, draws = _dispatch_bundles(card, n=5, tmp_path=tmp_path, **options)
    (m1, o1), *eager_bundles = bundles
    multi = T.make_multi_train_step(cfg, m1, o1, 3, provider=provider)
    mean, aux = multi(batches, draws)
    torch.cuda.synchronize()
    assert multi.graph is not None and multi.capture_seconds > 0
    graph = {k: v.clone() for k, v in multi.step_metrics.items()}
    runs = []
    for m2, o2 in eager_bundles:
        per = [T.train_step(cfg, m2, o2, {k: v[j] for k, v in batches.items()},
                            draws={k: v[j] for k, v in draws.items()}, provider=provider)[0] for j in range(3)]
        runs.append({k: torch.stack([e[k] for e in per]) for k in per[0]})
    updates = torch.arange(3, device=card).clamp(min=1)  # Adam updates behind each step's metrics
    floor = 0.1 if cfg.compute_dtype == "bfloat16" else 1e-4 * updates
    eager = runs[0]
    for k in eager:
        if k != "grad_norm":
            assert torch.equal(graph[k][0], eager[k][0]), k
        gap = max(float((x[k] - y[k]).abs().max()) for i, x in enumerate(runs) for y in runs[i + 1:])
        bound = torch.maximum(torch.full_like(eager[k], 2 * gap), floor * eager[k].abs())
        assert bool(((graph[k] - eager[k]).abs() <= bound).all()), (k, graph[k], eager[k], gap)
        assert torch.equal(mean[k], graph[k].mean()), k

    def params_apart(a, b):
        d = torch.cat([(x - y).abs().flatten() for x, y in zip(a.params, b.params)])
        return float(d.max()), float((d > 2e-5).float().mean())

    opts = [o for _, o in eager_bundles]
    assert o1.count == opts[0].count == 3
    biggest, share = params_apart(o1, opts[0])
    eager_share = max(params_apart(a, b)[1] for i, a in enumerate(opts) for b in opts[i + 1:])
    assert biggest <= 2 * cfg.learning_rate * 3, biggest
    if cfg.compute_dtype == "float32":
        assert share <= max(2 * eager_share, 1e-4), (share, eager_share)
    assert torch.isfinite(aux.min_mobiles[0]).all()


def test_graph_dispatch_makes_no_host_sync(card):
    """The draws, the copies into the static inputs and the replay: none
    waits for the device."""
    from mdn_sfm_tpu_torch import training as T

    cfg, _, ((models, opt), _), batches, draws = _dispatch_bundles(card)
    multi = T.make_multi_train_step(cfg, models, opt, 3)
    multi(batches, draws)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")  # the first switch of the mode may sync itself
    torch.cuda.set_sync_debug_mode("error")
    try:
        multi(batches, T.multi_step_draws(cfg, batches, 3))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert opt.count == 6


@pytest.mark.parametrize("mode", ["TG", "DS"])
def test_graph_launch_counts_are_honest(card, tmp_path, mode):
    """The capture launches nothing, so it counts nothing; each replay
    counts what it launches: a TG step 1 epipolar launch for 8 maps, a
    fused DS step also 2 NMS and 2 ROIAlign launches."""
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.ops import epipolar as E
    from mdn_sfm_tpu_torch.ops import nms as N
    from mdn_sfm_tpu_torch.ops import roi_align as RA

    cfg, provider, ((models, opt), _), batches, draws = _dispatch_bundles(card, tmp_path=tmp_path, mode=mode)
    multi = T.make_multi_train_step(cfg, models, opt, 3, provider=provider)
    multi.capture(batches, draws)
    per_step = [1, 8, 2, 2] if mode == "DS" else [1, 8, 0, 0]
    assert list(multi.captured_launches.values()) == [3 * n for n in per_step]

    def counts():
        return [E.epipolar_abs_residual_maps.launches, E.epipolar_abs_residual_maps.maps, N.nms.launches,
                RA.multilevel_roi_align.launches]

    before = counts()
    for _ in range(2):
        multi(batches, draws)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [6 * n for n in per_step]
    assert multi.replays == 2


def test_failed_capture_raises(card):
    """A step that reads a value on the host cannot be captured: the
    dispatch raises rather than run eagerly."""
    from mdn_sfm_tpu_torch import training as T

    cfg, _, ((models, opt), _), batches, draws = _dispatch_bundles(card)

    class Syncing:
        def union_fn(self, images):
            return torch.zeros_like(images[..., 0]) + float(images.sum())  # a host read

    multi = T.make_multi_train_step(cfg, models, opt, 3, provider=Syncing())
    with pytest.raises(RuntimeError):
        multi(batches, draws)
    assert multi.graph is None


# ------------------------------------ data parallelism: a one-rank NCCL group


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_one_rank_nccl_step_equals_the_step_without_a_group(card, tmp_path, graph):
    """K = 3 f32 steps through a one-rank NCCL group (eager, or one replay of
    a graph that holds the three all-reduces) against four runs of the same
    steps with no group from the same state and draws, by chip_smoke.py
    phase 11's rule (its ``_against_eager``: step 0's losses bit for bit,
    every metric within twice the runs' largest gap or 3e-5 relative, the
    params within twice their largest gap or 2·lr a step with few past
    2e-5)."""
    import torch.distributed as dist

    from chip_smoke import _against_eager
    from mdn_sfm_tpu_torch import training as T
    from mdn_sfm_tpu_torch.parallel import init_distributed, shutdown_distributed

    k = 3
    cfg, _, bundles, batches, draws = _dispatch_bundles(card, k=k, n=5)
    (models, opt), *eager_bundles = bundles

    def host(metrics, o):
        return {key: v.cpu() for key, v in metrics.items()}, [p.detach().cpu() for p in o.params]

    def steps(m, o, group=None):
        per = [T.train_step(cfg, m, o, {key: v[j] for key, v in batches.items()},
                            draws={key: v[j] for key, v in draws.items()}, group=group)[0] for j in range(k)]
        return {key: torch.stack([e[key] for e in per]) for key in per[0]}

    runs = [host(steps(m, o), o) for m, o in eager_bundles]
    init_distributed(card, 1, 0, f"file://{tmp_path / 'store'}")
    try:
        group = dist.group.WORLD
        if graph:
            multi = T.make_multi_train_step(cfg, models, opt, k, group=group)
            multi(batches, T.multi_step_draws(cfg, batches, 0, group))
            torch.cuda.synchronize()
            assert multi.graph is not None and multi.replays == 1
            got = host(multi.step_metrics, opt)
        else:
            got = host(steps(models, opt, group), opt)
    finally:
        shutdown_distributed()
    res = _against_eager(got, runs, cfg.learning_rate, k)
    assert res["ok"], res
    assert opt.count == k


# ---------------------------------------------------------------- the tools
# quantify_d2_scale and generate_mobile_gt's predict phase at a small size,
# every Mask R-CNN in f32 (the backend and providers build bf16 networks;
# here each model is rebuilt in f32 with the same weights), card against CPU


def _f32_pipelines(device):
    from mdn_sfm_tpu_torch import quantify_d2_scale as Q
    from mdn_sfm_tpu_torch.masks.crafted import brightness_detector_state_dict
    from mdn_sfm_tpu_torch.masks.maskrcnn import build_model_and_weights

    backend, providers = Q.build_pipelines((1, 2), 64, 128, 8, input_hw=(128, 256), fast=True, device=device)
    crafted = brightness_detector_state_dict()
    backend.model = build_model_and_weights(8, crafted, fast=True, dtype=torch.float32, device=device)
    for prov in providers.values():
        prov.model = build_model_and_weights(8, crafted, fast=True, score_thresh=prov.model.score_thresh,
                                             roi_dtype=torch.float32, dtype=torch.float32, device=device)
    return backend, providers


# f32 card against CPU: the detection counts equal, each IoU within this
# (cuDNN and the CPU sum a convolution's taps in other orders)
TOOL_IOU_ATOL = 0.01


def test_quantify_rows_on_the_card_equal_the_cpu(card):
    from mdn_sfm_tpu_torch import quantify_d2_scale as Q

    rows = {dev: Q.measure(*_f32_pipelines(dev), 2, 64, 128, scene_hw=(128, 256))[0] for dev in ("cpu", card)}
    for got, want in zip(rows[card], rows["cpu"]):
        assert want["n_backend"] > 0
        for key in want:
            if key.startswith("n_") or key == "image":
                assert got[key] == want[key], key
            else:
                assert abs(got[key] - want[key]) <= TOOL_IOU_ATOL, (key, got[key], want[key])


def test_generate_mobile_gt_predict_on_the_card_equals_the_cpu(card, tmp_path):
    import numpy as np
    from PIL import Image

    from mdn_sfm_tpu_torch import generate_mobile_gt as G
    from mdn_sfm_tpu_torch.data.worlds import _write_png8, make_street_scene

    for i in range(2):
        _write_png8(str(tmp_path / "images" / f"{i:06d}_10.png"), make_street_scene(128, 256, seed=i)[0])
    out = {}
    for dev in ("cpu", card):
        pred = tmp_path / f"pred_{dev}"
        args = G.get_argparser().parse_args(["--input", str(tmp_path / "images"), "--pred_output", str(pred),
                                             "--phase", "predict"])
        G.predict_with_model(args, backend=_f32_pipelines(dev)[0])
        out[dev] = {str(p.relative_to(pred)): np.asarray(Image.open(p)) for p in sorted(pred.rglob("*.png"))}
    assert out[card].keys() == out["cpu"].keys() and len(out["cpu"]) > 0
    for name, want in out["cpu"].items():
        got = out[card][name]
        inter, union = ((got > 0) & (want > 0)).sum(), ((got > 0) | (want > 0)).sum()
        assert inter / max(union, 1) >= 1 - TOOL_IOU_ATOL, name
