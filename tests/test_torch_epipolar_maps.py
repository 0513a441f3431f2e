"""The port's many-map epipolar entry, ``ops.epipolar.epipolar_abs_residual_maps``:
its plain version against the Pallas kernel (interpret mode) for each
(frame, scale) of a step, and the segment table that the CUDA kernel reads,
walked in Python with the kernel's own index arithmetic. The kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu.geometry import invert_intrinsics, scale_factor as jax_scale_factor
from mdn_sfm_tpu.geometry import transformation_from_parameters
from mdn_sfm_tpu.ops.pallas_epipolar import epipolar_abs_residual_pallas
from mdn_sfm_tpu_torch import geometry as tg
from mdn_sfm_tpu_torch.ops import epipolar as te
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(REPO, "mdn_sfm_tpu_torch", "csrc", "epipolar.cu")
# same formulas in f32 on both sides (the bound tests/test_torch_epipolar.py
# uses for the one-map case)
ATOL = RTOL = 1e-4

B, H, W = 2, 32, 96
SCALES = (0, 1, 2, 3)
FRAMES = (-1, 1)


@pytest.fixture(scope="module")
def step_inputs():
    """A step's inputs as the loss hands them over: each frame's normalized
    flow a deinterleaved view of one (B·2, Hs, Ws, 2) tensor, inv_K (B, 4, 4)
    per scale, and each frame's (B, 4, 4) pose."""
    rng = np.random.default_rng(0)
    flows = {}
    for s in SCALES:
        hs, ws = H >> s, W >> s
        both = (rng.normal(size=(B, 2, hs, ws, 2)) * 3 / np.array([ws, hs])).astype(np.float32)
        for fi, f in enumerate(FRAMES):
            flows[(f, s)] = both[:, fi]
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.58 * W, 1.92 * H, W / 2, H / 2
    inv_Ks = {}
    for s in SCALES:
        Ks = K.copy()
        Ks[:2] /= 2**s
        inv_Ks[s] = np.array(invert_intrinsics(jnp.asarray(np.broadcast_to(Ks, (B, 4, 4)))))
    cams = {}
    for f in FRAMES:
        aa = (rng.normal(size=(B, 1, 1, 3)) * 0.02).astype(np.float32)
        t = (rng.normal(size=(B, 1, 1, 3)) * 0.3).astype(np.float32)
        cams[f] = np.array(transformation_from_parameters(jnp.asarray(aa), jnp.asarray(t)))
    return flows, inv_Ks, cams


def _torch_maps(flows, inv_Ks, cams):
    keys = [(f, s) for s in SCALES for f in FRAMES]
    maps = []
    for f, s in keys:
        T = torch.from_numpy(cams[f])
        flow = torch.from_numpy(np.ascontiguousarray(flows[(f, s)]))
        maps.append(te.EpipolarMap(flow, (float(W >> s), float(H >> s)), torch.from_numpy(inv_Ks[s]),
                                   T[:, :3, :3], T[:, :3, 3]))
    return keys, maps


@pytest.fixture(scope="module")
def port_maps(step_inputs):
    keys, maps = _torch_maps(*step_inputs)
    return dict(zip(keys, te.epipolar_abs_residual_maps(maps)))


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("scale", SCALES)
def test_maps_plain_matches_pallas_interpret(step_inputs, port_maps, frame, scale):
    """Each map of the one call equals the Pallas kernel on the flow scaled
    to pixels by JAX's ``scale_factor``."""
    flows, inv_Ks, cams = step_inputs
    hs, ws = H >> scale, W >> scale
    flow_px = jnp.asarray(flows[(frame, scale)]) * jax_scale_factor(hs, ws)
    T = jnp.asarray(cams[frame])
    want = epipolar_abs_residual_pallas(flow_px, jnp.asarray(inv_Ks[scale]), T[:, :3, :3], T[:, :3, 3],
                                        interpret=True)
    got = port_maps[(frame, scale)]
    assert got.shape == (B, hs, ws) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_maps_cpu_equal_one_map_calls_on_pixel_flow(step_inputs, port_maps):
    """On the CPU the many-map entry is the one-map plain version on
    ``flow · scale_factor``, bit for bit, and launches nothing."""
    flows, inv_Ks, cams = step_inputs
    n0 = (te.epipolar_abs_residual_maps.launches, te.epipolar_abs_residual_maps.maps)
    for (f, s), got in port_maps.items():
        T = torch.from_numpy(cams[f])
        flow_px = torch.from_numpy(np.ascontiguousarray(flows[(f, s)])) * tg.scale_factor(H >> s, W >> s)
        want = te.epipolar_abs_residual(flow_px, torch.from_numpy(inv_Ks[s]), T[:, :3, :3], T[:, :3, 3])
        torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert (te.epipolar_abs_residual_maps.launches, te.epipolar_abs_residual_maps.maps) == n0


@pytest.mark.parametrize("scale", [(96.0, 32.0), (1.0 / 3.0, 7.5)])
def test_to_pixels_rounds_as_scale_factor_product(scale):
    flow = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 4, 6, 2)).astype(np.float32))
    want = flow * torch.tensor(scale, dtype=torch.float32)
    torch.testing.assert_close(te._to_pixels(flow, scale), want, atol=0, rtol=0)


def test_scale_factor_is_cached_and_matches_jax():
    """The loss's pixel scale is a cached constant (no host-to-device copy
    a step on the card), equal to JAX's."""
    sf = tg.scale_factor(24, 80)
    assert tg.scale_factor(24, 80) is sf
    np.testing.assert_array_equal(sf.numpy(), np.asarray(jax_scale_factor(24, 80)))


# ------------------------------------------------------- the segment table


def _flow(layout: str, b: int, h: int, w: int) -> torch.Tensor:
    """A (b, h, w, 2) flow tensor in one of the layouts the kernel meets."""
    g = torch.Generator().manual_seed(b * 1000 + h * 10 + w)
    if layout == "dense":
        return torch.randn(b, h, w, 2, generator=g)
    if layout == "loss_view":  # channels-last net output, one frame of the 2B stack
        both = torch.randn(2 * b, 2, h, w, generator=g).contiguous(memory_format=torch.channels_last)
        return both.permute(0, 2, 3, 1).reshape(b, 2, h, w, 2)[:, 1]
    if layout == "nchw_view":
        return torch.randn(b, 2, h, w, generator=g).permute(0, 2, 3, 1)
    if layout == "misaligned":  # 8-byte-aligned base
        return torch.randn(b * h * w * 2 + 2, generator=g)[2:].view(b, h, w, 2)
    if layout == "cropped":  # a column crop that keeps pairs aligned
        return torch.randn(b, h, w + 2, 2, generator=g)[:, :, 2:]
    if layout == "every_other_column":
        return torch.randn(b, h, 2 * w, 2, generator=g)[:, :, ::2]
    raise ValueError(layout)


def _map(flow: torch.Tensor) -> "te.EpipolarMap":
    b = flow.shape[0]
    cam = torch.eye(4).repeat(b, 1, 1)
    cam[:, :3, 3] = torch.tensor([0.1, -0.2, 0.9])
    return te.EpipolarMap(flow, (float(flow.shape[2]), float(flow.shape[1])), torch.eye(4).expand(b, 4, 4),
                          cam[:, :3, :3], cam[:, :3, 3])


@pytest.mark.parametrize("layout,shape,vec", [
    ("dense", (2, 6, 8), True),
    ("loss_view", (4, 12, 40), True),
    ("cropped", (1, 3, 6), True),
    ("dense", (2, 5, 7), False),          # odd W
    ("loss_view", (2, 3, 5), False),      # odd W
    ("nchw_view", (2, 6, 8), False),      # c-stride H·W
    ("misaligned", (1, 4, 8), False),     # base 8-byte aligned
    ("every_other_column", (1, 4, 8), False),  # w-stride 4
])
def test_vector_flag_only_for_the_16_byte_layout(layout, shape, vec):
    flow = _flow(layout, *shape)
    assert te.vector_layout(flow) is vec
    out = torch.empty(te.out_offsets([_map(flow)])[1])
    assert te.build_table([_map(flow)], out).seg[0].vec == int(vec)


def _walk(table: "te._Table", maps, out: torch.Tensor, blocks=None):
    """Every (segment, image, pixel) the kernel's blocks (all, or those of
    ``blocks``) touch, with the output and flow addresses, by the kernel's
    own index arithmetic (csrc/epipolar.cu)."""
    hits = []
    tid = np.arange(te.THREADS)
    for bid in range(table.total_blocks) if blocks is None else blocks:
        s, step = 0, te.MAX_SEGMENTS // 2
        while step:
            if s + step < table.n and bid >= table.seg[s + step].block0:
                s += step
            step //= 2
        sg = table.seg[s]
        local = bid - sg.block0
        b, tile = divmod(local, sg.blocks_per_image)
        assert b < maps[s].flow.shape[0], "a block past its segment's last image"
        assert max(bid, local, b, tile) < 2**31, "a block index past the kernel's int"
        hw = sg.height * sg.width
        px = te.VEC_PIXELS if sg.vec else 1
        base = tile * te.THREADS * te.ITEMS * px
        for p in (base + (np.arange(te.ITEMS)[:, None] * te.THREADS + tid).ravel() * px):
            if p >= hw:
                continue
            y, x = divmod(int(p), sg.width)
            assert y < 2**31, "a row past the kernel's int"
            fs = list(sg.flow_stride)
            flow_el = b * fs[0] + y * fs[1]
            out_el = sg.out_offset + b * hw + p
            if sg.vec:
                assert x + 1 < sg.width, "a pixel pair across a row end"
                assert (sg.flow + 4 * (flow_el + 2 * x)) % 16 == 0, "unaligned float4 load"
                assert (out.data_ptr() + 4 * out_el) % 8 == 0, "unaligned float2 store"
                hits += [(s, b, p, out_el, flow_el + 2 * x), (s, b, p + 1, out_el + 1, flow_el + 2 * x + 2)]
            else:
                hits.append((s, b, p, out_el, flow_el + x * fs[2]))
    return hits


SEGMENT_SETS = {
    "main_path": [("loss_view", (2, 32 >> s, 96 >> s)) for s in SCALES for _ in FRAMES],
    "ragged": [("dense", (1, 37, 83)), ("loss_view", (2, 5, 6)), ("nchw_view", (3, 1, 1)),
               ("dense", (2, 7, 10)), ("cropped", (1, 9, 514)), ("misaligned", (2, 3, 4)),
               ("dense", (1, 0, 4)), ("dense", (2, 17, 31))],
    "one": [("dense", (3, 1, 5))],
    "cap": [("dense", (1, 2, 2 * k + 1)) for k in range(te.MAX_SEGMENTS)],
}


@pytest.mark.parametrize("name", sorted(SEGMENT_SETS))
def test_table_blocks_cover_every_pixel_once(name):
    maps = [_map(_flow(layout, *shape)) for layout, shape in SEGMENT_SETS[name]]
    offsets, total = te.out_offsets(maps)
    out = torch.empty(total)
    table = te.build_table(maps, out)
    assert table.n == len(maps)
    assert all(o % 4 == 0 for o in offsets)  # every map 16-byte aligned
    hits = _walk(table, maps, out)
    want = {(s, b, p) for s, m in enumerate(maps)
            for b in range(m.flow.shape[0]) for p in range(m.flow.shape[1] * m.flow.shape[2])}
    got = [h[:3] for h in hits]
    assert len(got) == len(set(got)) and set(got) == want
    out_els = [h[3] for h in hits]
    assert len(out_els) == len(set(out_els)) and max(out_els, default=0) < total
    for s, b, p, out_el, flow_el in hits:  # the element read is the pixel's u by the view's strides
        sb, sh, sw, _ = maps[s].flow.stride()
        y, x = divmod(p, maps[s].flow.shape[2])
        assert flow_el == b * sb + y * sh + x * sw
        assert out_el == offsets[s] + b * maps[s].flow.shape[1] * maps[s].flow.shape[2] + p


@pytest.mark.parametrize("b,h,w,vec", [
    (1, 4096, 4096, True),
    (2, 4097, 4095, False),            # odd W: the scalar path
    (1, 3, (1 << 24) + 2, True),       # a row wider than an f32 integer
    (1, 1 << 16, (1 << 15) + 2, True),  # H·W above 2^31
])
def test_table_of_a_large_map_covers_it(b, h, w, vec):
    """Any H·W: the first and last blocks of each image reach its first and
    last pixels, and the blocks between cover the rest, with every index
    the kernel keeps in an int below 2^31. The flow is a broadcast row, so
    nothing of the map's size is allocated."""
    flow = torch.zeros(1, 1, w, 2).expand(b, h, w, 2)
    assert te.vector_layout(flow) is vec
    m = _map(flow)
    table = te.build_table([m], torch.empty(4))
    sg = table.seg[0]
    per_block = te.THREADS * te.ITEMS * (te.VEC_PIXELS if vec else 1)
    assert sg.blocks_per_image == -(-(h * w) // per_block) and table.total_blocks == b * sg.blocks_per_image
    for i in range(b):
        first = i * sg.blocks_per_image
        last = first + sg.blocks_per_image - 1
        ps = sorted(p for _, _, p, _, _ in _walk(table, [m], torch.empty(4), blocks=[last]))
        assert ps[-1] == h * w - 1 and len(set(ps)) == len(ps)
        assert (sg.blocks_per_image - 1) * per_block + len(ps) == h * w
        ps = [p for _, bb, p, _, _ in _walk(table, [m], torch.empty(4), blocks=[first])]
        assert min(ps) == 0 and len(ps) == min(per_block, h * w)


@pytest.mark.parametrize("where", ["second_map_on_meta", "first_map_on_meta", "rotation_on_meta"])
def test_maps_across_devices_raise(where):
    """Every tensor of every map must be on one device before a path is
    chosen: a CPU first map does not send later maps to the plain version."""
    cpu = _map(_flow("dense", 2, 4, 6))
    meta = te.EpipolarMap(*(x.to("meta") if isinstance(x, torch.Tensor) else x for x in cpu))
    maps = {"second_map_on_meta": [cpu, meta], "first_map_on_meta": [meta, cpu],
            "rotation_on_meta": [cpu._replace(rotation=cpu.rotation.to("meta"))]}[where]
    with pytest.raises(ValueError, match="on one device"):
        te.epipolar_abs_residual_maps(maps)


def test_segment_cap_raises():
    maps = [_map(_flow("dense", 1, 2, 2))] * (te.MAX_SEGMENTS + 1)
    out = torch.empty(te.out_offsets(maps)[1])
    with pytest.raises(ValueError, match="1 to 16 maps"):
        te.build_table(maps, out)
    with pytest.raises(ValueError, match="1 to 16 maps"):
        te.epipolar_abs_residual_maps(maps)
    with pytest.raises(ValueError, match="1 to 16 maps"):
        te.epipolar_abs_residual_maps([])


@pytest.mark.parametrize("field,bad,match", [
    ("rotation", lambda m: m.rotation.new_zeros(m.flow.shape[0], 4, 4), "does not fit"),
    ("translation", lambda m: m.translation[:1], "does not fit"),
    ("inv_K", lambda m: m.inv_K.double(), "must be float32"),
    ("flow", lambda m: m.flow.double(), "must be \\(B, H, W, 2\\) float32"),
])
def test_checks_refuse_what_the_kernel_cannot_read(field, bad, match):
    m = _map(_flow("dense", 2, 4, 6))
    with pytest.raises(ValueError, match=match):
        te._check([m._replace(**{field: bad(m)})])


def _cu_asserts(kind: str) -> dict[tuple[str, ...], int]:
    src = open(CU).read()
    if kind == "offsetof":
        found = re.findall(r"static_assert\(offsetof\((\w+), (\w+)\) == (\d+)", src)
        return {(s, f): int(n) for s, f, n in found}
    return {(s,): int(n) for s, n in re.findall(r"static_assert\(sizeof\((\w+)\) == (\d+)", src)}


def test_ctypes_table_mirrors_the_cu_layout():
    """Every field offset and size that csrc/epipolar.cu pins with
    static_assert equals the ctypes Structure's, field for field, and the
    kernel's constants equal the wrapper's."""
    structs = {"Segment": te._Segment, "Table": te._Table}
    offsets = _cu_asserts("offsetof")
    for name, st in structs.items():
        fields = [f for f, _ in st._fields_]
        assert [f for s, f in offsets if s == name] == fields
        for f in fields:
            assert getattr(st, f).offset == offsets[(name, f)], (name, f)
    assert {s: ctypes.sizeof(st) for s, st in structs.items()} == {s: n for (s,), n in _cu_asserts("sizeof").items()}
    src = open(CU).read()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert consts == {"kMaxSegments": te.MAX_SEGMENTS, "kThreads": te.THREADS, "kVecPixels": te.VEC_PIXELS,
                      "kItems": te.ITEMS}
