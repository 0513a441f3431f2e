"""The port's roofline (``mdn_sfm_tpu_torch.roofline``, the counterpart of
``tools/roofline.py``) on the CPU at 32×64: what it counts, not what it
times (a time comes from the card only).

The FLOP counter equals a count built from the convolutions' shapes,
2·N·Cout·Hout·Wout·Cin·k²/groups, exactly: the eval forward's, and the TG
train step's forward plus its backward (the weight gradient of every
trained convolution, the input gradient where the input needs one). The
byte counter agrees with hand counts. The epipolar kernel's work is 8 maps
× pixels × ``EPI_FLOP_PER_PX``, the fused Mask R-CNN's two NMS and two
ROIAlign calls are counted, and ``chip_smoke.py`` takes these
formulas from the roofline. The tool refuses the CPU and a card or part its
table lacks. About 25 s on one worker."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mdn_sfm_tpu_torch import roofline as R
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tool_flags import defaults, jax_parser

H, W, B = 32, 64, 2
H100 = "NVIDIA H100 80GB HBM3"


def _cfg(**kw):
    return Config(height=H, width=W, batch_size=B, mode=Mode.TG, threshold=9.22, w_d2_sim=0.0,
                  compute_dtype="float32", **kw).validate()


class _ConvShapes:
    """Forward hooks on every Conv2d of the nets: each call's FLOPs from its
    shapes, and whether its input and weight need a gradient."""

    def __init__(self, models):
        self.calls = []
        self.handles = [m.register_forward_hook(self._hook) for net in models for m in net.modules()
                        if isinstance(m, torch.nn.Conv2d)]

    def _hook(self, m, inputs, out):
        n, cout, ho, wo = out.shape
        kk = m.kernel_size[0] * m.kernel_size[1]
        flops = 2 * n * cout * ho * wo * m.in_channels * kk // m.groups
        self.calls.append((flops, inputs[0].requires_grad, m.weight.requires_grad))

    def forward(self) -> int:
        return sum(f for f, _, _ in self.calls)

    def backward(self) -> int:
        return sum(f * (x_grad + w_grad) for f, x_grad, w_grad in self.calls)

    def remove(self):
        for h in self.handles:
            h.remove()


@pytest.fixture(scope="module")
def tg():
    cfg = _cfg()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cpu")
    colors, K = synthetic_batch(B, H, W, seed=0)
    batch = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)}
    return cfg, models, T.make_optimizer(cfg, models, steps_per_epoch=1000), batch


def test_eval_forward_flops_equal_the_conv_shapes(tg):
    cfg, models, _, _ = tg
    shapes = _ConvShapes(models)
    rng = torch.Generator().manual_seed(0)
    tgt, ref = (torch.randn(B, H, W, 3, generator=rng) for _ in range(2))
    try:
        with FlopCounterMode(display=False) as flops:
            T.eval_forward(cfg, models, tgt, ref)
    finally:
        shapes.remove()
    assert flops.get_total_flops() == shapes.forward() > 0
    assert {str(op) for op in flops.get_flop_counts()["Global"]} == {"aten.convolution"}


def test_train_step_flops_equal_forward_and_backward_conv_shapes(tg):
    """Exact (tolerance 0): the step's only counted ops are convolutions and
    their backward."""
    cfg, models, opt, batch = tg
    shapes = _ConvShapes(models)
    try:
        counted = R.count_step(cfg, models, opt, batch, T.step_generator(cfg.seed, 0, "cpu"))
    finally:
        shapes.remove()
    assert shapes.backward() > 0
    assert counted["aten_flops"] == shapes.forward() + shapes.backward()
    assert counted["flops"] == counted["aten_flops"] + counted["kernels"]["epipolar"]["flops"]
    assert counted["bytes"] == counted["aten_bytes"] + counted["kernels"]["epipolar"]["bytes"] > 0


def test_epipolar_term_is_8_maps_of_pixels(tg):
    cfg, models, opt, batch = tg
    counted = R.count_step(cfg, models, opt, batch, T.step_generator(cfg.seed, 1, "cpu"))
    pixels = len(cfg.ref_frame_ids) * sum(B * (H >> s) * (W >> s) for s in cfg.scales)
    assert counted["kernels"]["epipolar"] == {
        "launches": 1, "maps": 8, "flops": pixels * R.EPI_FLOP_PER_PX,
        "bytes": pixels * (2 * 4 + 4) + 8 * B * (9 + 9 + 3) * 4}
    assert counted["kernels"]["nms"]["launches"] == counted["kernels"]["roi_align"]["launches"] == 0


def test_mask_rcnn_kernel_calls_are_counted():
    """The Mask R-CNN's NMS and ROIAlign entries, called as its forward calls
    them, are recorded with their work: NMS's IoUs are each kept box against
    every box after it in score order (here boxes 0 and 2 of 4 kept: 4 + 2)."""
    from mdn_sfm_tpu_torch.masks import maskrcnn

    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 9], [20, 20, 30, 30], [20, 20, 30, 29]]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8, 0.7, 0.6]])
    feats = [torch.ones(1, 32 >> lvl, 32 >> lvl, 8) for lvl in range(4)]
    with R.kernel_calls() as calls:
        keep, valid = maskrcnn.nms(boxes, scores, 0.5, 2)
        maskrcnn.multilevel_roi_align(feats, boxes, 7)
    assert keep.tolist() == [[0, 2]] and valid.tolist() == [[True, True]]
    work = R.kernel_work(calls)
    assert work["nms"] == {"launches": 1, "bytes": 4 * 20 + 2 * 5, "flops": (4 + 2) * R.NMS_IOU_FLOP}
    outputs = 4 * 7 * 7 * 8
    assert work["roi_align"]["launches"] == 1 and work["roi_align"]["flops"] == outputs * R.ROI_FLOP_PER_OUTPUT
    assert work["roi_align"]["bytes"] > outputs * 4 + 16 * 4
    assert work["epipolar"] == {"launches": 0, "bytes": 0, "flops": 0, "maps": 0}
    assert maskrcnn.nms.__module__ == "mdn_sfm_tpu_torch.ops.nms"  # the entry is restored


@pytest.mark.parametrize("case,op,shapes,want", [
    ("add", lambda a, b: a + b, [(4, 8), (4, 8)], 3 * 32 * 4),
    ("add_ in place", lambda a, b: a.add_(b), [(4, 8), (4, 8)], 3 * 32 * 4),  # reads both, writes its target
    ("view", lambda a: a.view(-1), [(4, 8)], 0),
    ("permute", lambda a: a.permute(1, 0), [(4, 8)], 0),
    ("broadcast", lambda a, b: a * b.expand(4, 8), [(4, 8), (1, 8)], (32 + 8 + 32) * 4),
    ("conv", torch.nn.functional.conv2d, [(1, 3, 8, 8), (4, 3, 3, 3), (4,)], (3 * 64 + 4 * 27 + 4 + 4 * 36) * 4),
    ("bf16 cast", lambda a: a.to(torch.bfloat16), [(4, 8)], 32 * 4 + 32 * 2),
])
def test_byte_counter_agrees_with_hand_counts(case, op, shapes, want):
    """Bytes of f32 tensors: each input read once, each output written once,
    a view nothing, a broadcast input its stored elements."""
    inputs = [torch.ones(*s) for s in shapes]
    with R.ByteCounter() as counted:
        op(*inputs)
    assert counted.bytes == want, case


def test_peaks_refuse_a_card_or_part_the_table_lacks():
    assert R.peaks(None, H100) == ("h100-sxm", 989e12, 3.35e12)
    assert R.peaks("h100-sxm", "another card") == ("h100-sxm", 989e12, 3.35e12)
    with pytest.raises(ValueError, match="no published peaks for the card"):
        R.peaks(None, "NVIDIA GeForce RTX 4090")
    with pytest.raises(ValueError, match="no published peaks for the part"):
        R.peaks("cpu", H100)
    assert "cpu" not in R.PEAKS and "device" not in defaults(R.build_parser())


def test_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the roofline runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.main(["--height", str(H), "--width", str(W), "--batch", str(B), "--k_steps", "2"])


def test_chip_smoke_takes_the_bounds_formulas_from_the_roofline():
    import chip_smoke

    for name in ("EPI_FLOP_PER_PX", "NMS_IOU_FLOP", "ROI_FLOP_PER_OUTPUT", "PEAK_BYTES_PER_S",
                 "PEAK_F32_FLOP_PER_S"):
        assert not hasattr(chip_smoke, name), name


def test_flags_are_the_jax_tools():
    want, got = defaults(jax_parser("roofline")), defaults(R.build_parser())
    assert set(got) == set(want)
    assert {k for k in got if got[k] != want[k]} == {"chip"}
    assert want["chip"][0] == "v5e" and got["chip"][0] is None  # a TPU part there; the card's own here
