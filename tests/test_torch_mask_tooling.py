"""The port's mask tooling against the JAX package's, on the CPU: the label
decoders, the instance-segmentation catalog (``masks/dataset``), the
synthetic writers (``data/worlds``) and ``generate_mobile_gt`` against the
JAX tool's own functions (``tools/generate_mobile_gt.py``, loaded by path).
Everything is exact but the Mask R-CNN ``predict`` phase, whose masks are
compared by IoU (the bound below). About 20 s on one worker."""

import filecmp
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import fixtures as F
import mdn_sfm_tpu.masks.maskrcnn as JM
from mdn_sfm_tpu import labels as JL
from mdn_sfm_tpu.masks import dataset as JD
from mdn_sfm_tpu_torch import generate_mobile_gt as G
from mdn_sfm_tpu_torch import labels as TL
from mdn_sfm_tpu_torch.data import worlds as TW
from mdn_sfm_tpu_torch.masks import dataset as TD
from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNBackend
from mdn_sfm_tpu_torch.weights import maskrcnn_state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE_HW = (128, 256)   # the predict phase's street scenes and the backend's static input
SCENE_SEEDS = (0, 1, 2)
MAX_DET = 8
# IoU of each pair of instance masks, port against JAX: measured 0.9982-1.0
# on these scenes (at most one pixel differs a mask; bf16 rounds at other
# places in the two frameworks), the bound leaves about twice that gap
PRED_IOU_MIN = 0.996


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_generate_mobile_gt",
                                                  os.path.join(REPO, "tools", "generate_mobile_gt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# ------------------------------------------------------------------ labels


def _label_values() -> list[int]:
    ids = [lab.id for lab in JL.LABELS] + [200]
    vals = {0, 255}
    for i in ids:
        vals |= {i, i * 256, i * 256 + 1, i * 256 + 7, i * 256 + 255, i * 1000, i * 1000 + 1, i * 1000 + 999}
    return sorted(vals)


@pytest.mark.parametrize("name", ["kitti_decode", "kitti_decode8", "cityscapes_pm_decode"])
def test_decoders_equal_jax(name):
    vals = _label_values()
    assert [getattr(TL, name)(v) for v in vals] == [getattr(JL, name)(v) for v in vals]


def test_thing_classes_equal_jax():
    assert TL.THING_CLASSES_11 == JL.THING_CLASSES_11 and TL.THING_CLASSES_8 == JL.THING_CLASSES_8


# ------------------------------------------------------- masks/dataset
# the trees of tests/test_mask_dataset.py, copied


def _kitti_instance_map():
    inst = np.full((24, 32), 7 * 256, np.int32)  # road (stuff → skipped)
    inst[2:8, 3:12] = 26 * 256 + 0    # car 0
    inst[10:20, 15:28] = 26 * 256 + 1  # car 1
    inst[4:9, 20:24] = 24 * 256 + 0   # person
    inst[20:23, 0:4] = 29 * 256 + 0   # caravan: a thing of the 11 classes only
    inst[0:2, 28:32] = 26 * 1000 + 1  # a car in Cityscapes' encoding (unknown to KITTI's)
    return inst


def _write_u16(path, arr):
    Image.fromarray(arr.astype(np.uint16)).save(path)


def _write_rgb(path, h, w):
    Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(path)


@pytest.fixture(scope="module")
def kitti_seg_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_seg")
    for sub, n in (("training", 2), ("validation", 1)):
        (root / sub / "instance").mkdir(parents=True)
        (root / sub / "image_2").mkdir(parents=True)
        for i in range(n):
            _write_u16(root / sub / "instance" / f"{i:06d}_10.png", _kitti_instance_map())
            _write_rgb(root / sub / "image_2" / f"{i:06d}_10.png", 24, 32)
    return str(root)


@pytest.fixture(scope="module")
def cityscapes_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cityscapes")
    inst = np.zeros((16, 20), np.int32)
    inst[2:6, 2:10] = 26000
    inst[8:12, 12:18] = 24001
    inst[13:15, 0:3] = 24  # a semantic-only person blob
    for split, cities in (("train", ["aachen", "bochum"]), ("val", ["frankfurt"])):
        for city in cities:
            gt = root / "gtFine" / split / city
            im = root / "leftImg8bit" / split / city
            gt.mkdir(parents=True)
            im.mkdir(parents=True)
            stem = f"{city}_000000_000019"
            _write_u16(gt / f"{stem}_gtFine_instanceIds.png", inst)
            _write_rgb(im / f"{stem}_leftImg8bit.png", 16, 20)
    return str(root)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("variant", sorted(JD.DATASET_VARIANTS))
def test_dataset_variants_equal_jax(kitti_seg_tree, variant, train):
    """Every catalog entry's dicts, exactly: file names, sizes, and each
    annotation's bbox, RLE counts and size, and category_id."""
    jwalk, jdec, jclasses = JD.DATASET_VARIANTS[variant]
    twalk, tdec, tclasses = TD.DATASET_VARIANTS[variant]
    want = jwalk(kitti_seg_tree, train=train, decoder=jdec)
    got = twalk(kitti_seg_tree, train=train, decoder=tdec)
    assert got == want and len(got) == (2 if train else 1) and got[0]["annotations"]
    assert tclasses == jclasses and tdec.__name__ == jdec.__name__


def test_catalog_keeps_the_kitti_walker_for_cityscapes():
    assert TD.DATASET_VARIANTS["cityscapes_pm_instance"][0] is TD.kitti_seg_instance


@pytest.mark.parametrize("train", [True, False])
def test_cityscapes_walker_equals_jax(cityscapes_tree, train):
    want = JD.cityscapes_pm_seg_instance(cityscapes_tree, train=train)
    got = TD.cityscapes_pm_seg_instance(cityscapes_tree, train=train)
    assert got == want and len(got) == (2 if train else 1)
    assert sorted(a["category_id"] for a in got[0]["annotations"]) == [1, 1, 3]


def test_instances_from_map_equals_jax():
    inst = _kitti_instance_map()
    for dec in ("kitti_decode", "kitti_decode8"):
        assert TD.instances_from_map(inst, getattr(TL, dec)) == JD.instances_from_map(inst, getattr(JL, dec))


# ------------------------------------------------------------ data/worlds


@pytest.mark.parametrize("writer,kw", [
    ("make_kitti2015", dict(n=2, h=24, w=40)),
    ("make_gt_masks", dict(n=3, h=24, w=40)),
    ("make_odometry", dict(seq="10", n_frames=4, h=24, w=40)),
    ("make_raw_drive", dict(n_frames=5, h=24, w=40)),
])
def test_world_writers_write_the_fixtures_bytes(tmp_path, writer, kw):
    want_root, got_root = str(tmp_path / "jax"), str(tmp_path / "port")
    want = getattr(F, writer)(want_root, **kw)
    got = getattr(TW, writer)(got_root, **kw)
    assert got == want
    want_tree, got_tree = _tree(want_root), _tree(got_root)
    assert want_tree and got_tree == want_tree


def test_png16_and_street_scene_equal_the_fixtures(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 65535, (5, 7, 3)).astype(np.uint16)
    for name, arr in (("rgb.png", rgb), ("gray.png", rgb[..., 0])):
        F.write_png16(str(tmp_path / "jax" / name), arr)
        TW.write_png16(str(tmp_path / "port" / name), arr)
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False)
    for seed in (0, 3):
        (a, ga), (b, gb) = F.make_street_scene(40, 96, seed=seed), TW.make_street_scene(40, 96, seed=seed)
        assert np.array_equal(a, b) and np.array_equal(ga, gb)


# ------------------------------------------------------ generate_mobile_gt


def _instance_tree(root: str) -> str:
    """KITTI instance maps ``*_10.png`` (16-bit): two with things, one of
    stuff alone, and a file the walker skips."""
    d = os.path.join(root, "instance")
    maps = [_kitti_instance_map(), np.full((24, 32), 7 * 256, np.int32), _kitti_instance_map()[::-1].copy()]
    for i, m in enumerate(maps):
        F.write_png16(os.path.join(d, f"{i:06d}_10.png"), m.astype(np.uint16))
    F.write_png16(os.path.join(d, "000000_11.png"), maps[0].astype(np.uint16))
    return d


def _args(tool, root: str, **kw):
    return tool.get_argparser().parse_args(
        ["--instance_dir", os.path.join(root, "instance"), "--pred_output", os.path.join(root, "pred"),
         "--gt_output", os.path.join(root, "gt"), "--input", os.path.join(root, "images")]
        + [x for k, v in kw.items() for x in (f"--{k}", str(v))])


def test_from_semantic_gt_and_generate_masks_equal_jax(tmp_path):
    """The instance PNGs of ``--from_semantic_gt`` and the GT masks of
    ``generate_masks`` (instances listed, an empty line, a single one) are
    the JAX tool's, file for file and byte for byte."""
    jtool = _jax_tool()
    trees = {}
    for side, tool in (("jax", jtool), ("port", G)):
        root = str(tmp_path / side)
        _instance_tree(root)
        tool.predict_from_semantic_gt(_args(tool, root, n_samples=3))
        os.makedirs(os.path.join(root, "gt"))
        with open(os.path.join(root, "gt", "instance_numbers.txt"), "w") as f:
            f.write("0 2\n\n1\n")
        tool.generate_masks(_args(tool, root, n_samples=3))
        trees[side] = _tree(root)
    assert trees["port"] == trees["jax"]
    names = set(trees["port"])
    assert {"pred/0/0.png", "pred/0/3.png", "pred/2/3.png", "gt/0.png", "gt/1.png", "gt/2.png"} <= names
    assert not any(n.startswith("pred/1/") for n in names)  # the stuff-only map
    with Image.open(tmp_path / "port" / "gt" / "1.png") as im:
        assert im.size == (1, 1) and not np.asarray(im).any()


def test_generate_masks_asserts_the_line_count(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "gt"))
    with open(os.path.join(root, "gt", "instance_numbers.txt"), "w") as f:
        f.write("0\n")
    with pytest.raises(AssertionError, match="Invalid instance numbers"):
        G.generate_masks(_args(G, root, n_samples=2))


@pytest.fixture(scope="module")
def predicted(tmp_path_factory):
    """The predict phase of both tools over the same street-scene PNGs,
    each with a fast backend at a 128×256 input on the crafted detector."""
    shapes = jax.eval_shape(JM.MaskRCNN(max_det=MAX_DET).init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                            jnp.array(64.0), jnp.array(64.0))
    crafted = F.craft_brightness_detector(shapes)
    jcrafted = jax.tree.map(jnp.asarray, crafted)
    real_backend = JM.MaskRCNNBackend

    def jax_backend(weights_path=None, mesh=None):
        assert weights_path is None and mesh is None
        with pytest.MonkeyPatch.context() as mp:  # the random init is replaced by the crafted tree below
            mp.setattr(JM.MaskRCNN, "init", lambda self, *a, **k: jcrafted)
            b = real_backend(max_det=MAX_DET, fast=True, input_hw=SCENE_HW)
        b.variables = jcrafted
        return b

    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path_factory.mktemp(side))
        for i, seed in enumerate(SCENE_SEEDS):
            F._write_png8(os.path.join(root, "images", f"{i:06d}_10.png"), F.make_street_scene(*SCENE_HW, seed=seed)[0])
        if side == "jax":
            tool = _jax_tool()
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(JM, "MaskRCNNBackend", jax_backend)
                tool.predict_with_model(_args(tool, root))
        else:
            backend = MaskRCNNBackend(maskrcnn_state_dict_from_flax(crafted), max_det=MAX_DET, fast=True,
                                      input_hw=SCENE_HW, device="cpu")
            G.predict_with_model(_args(G, root), backend=backend)
        out[side] = root
    return out


def _masks(root: str, n: int) -> list[np.ndarray]:
    d = os.path.join(root, "pred", str(n))
    files = sorted(os.listdir(d), key=lambda f: int(f.split(".")[0])) if os.path.isdir(d) else []
    assert files == [f"{i}.png" for i in range(len(files))]
    out = []
    for f in files:
        with Image.open(os.path.join(d, f)) as im:
            a = np.asarray(im)
        assert a.shape == (*SCENE_HW, 3) and set(np.unique(a)) <= {0, 255}
        out.append(a[..., 0] > 0)
    return out


@pytest.mark.parametrize("image", range(len(SCENE_SEEDS)))
def test_predict_equals_jax(predicted, image):
    """The same number of instance PNGs an image, each pair's IoU at least
    PRED_IOU_MIN, and every differing pixel on an object's boundary."""
    got, want = _masks(predicted["port"], image), _masks(predicted["jax"], image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        iou = float((g & w).sum() / max((g | w).sum(), 1))
        assert iou >= PRED_IOU_MIN, iou
        union, inter = np.pad(g | w, 1), np.pad(g & w, 1)
        ys, xs = np.nonzero(g ^ w)
        for y, x in zip(ys + 1, xs + 1):
            assert union[y - 1:y + 2, x - 1:x + 2].any() and not inter[y - 1:y + 2, x - 1:x + 2].all()


def test_predict_warns_and_builds_the_1024_edge_backend_without_weights(tmp_path, monkeypatch, capsys):
    """No --weights: the warning, then the backend at its static input on
    --device (the backend is replaced by a recorder here)."""
    made = {}

    class Backend:
        def __init__(self, **kw):
            made.update(kw)

        def predict(self, img):
            return np.ones((1, *img.shape[:2]), np.uint8), None, None, None

    from mdn_sfm_tpu_torch.masks import maskrcnn

    monkeypatch.setattr(maskrcnn, "MaskRCNNBackend", Backend)
    root = str(tmp_path)
    F._write_png8(os.path.join(root, "images", "a.png"), np.zeros((4, 6, 3), np.uint8))
    G.predict_with_model(_args(G, root, device="cpu"))
    assert made == {"weights_path": None, "device": "cpu"}
    assert "RANDOM Mask R-CNN" in capsys.readouterr().out
    with Image.open(os.path.join(root, "pred", "0", "0.png")) as im:
        assert np.asarray(im).min() == 255


def test_cli_flags_are_the_jax_tools_less_spatial_shards_plus_device():
    def flags(parser):
        return {a.dest: (a.default, a.choices) for a in parser._actions if a.dest != "help"}

    j, t = flags(_jax_tool().get_argparser()), flags(G.get_argparser())
    assert set(j) - set(t) == {"spatial_shards"} and set(t) - set(j) == {"device"}
    assert all(t[k] == j[k] for k in t if k != "device") and t["device"][0] == "cuda"
    assert "--spatial_shards" in G.get_argparser().format_help()
