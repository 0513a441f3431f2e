"""The DS/DC supervision stack of the port on the CPU: the mask providers
(the precomputed PNG rules against the JAX package's provider), the live
Mask R-CNN provider's guards, the step with the provider fused into it
against the step fed the same augmented frame's masks, the Trainer's
precomputed coverage probe, and ``python -m mdn_sfm_tpu_torch.precompute_masks``
writing the keys the Trainer then serves. Shapes: 64×96 training,
``d2_infer_scale=2``; the Mask R-CNN's weights are the crafted brightness
detector of ``tests/fixtures.py`` saved as a detectron2 ``.pth``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mdn_sfm_tpu.masks.maskrcnn as M
from fixtures import craft_brightness_detector, make_bright_raw_drive
from mdn_sfm_tpu.masks.providers import PrecomputedMaskProvider as JPrecomputed
from mdn_sfm_tpu_torch import config as tconfig
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.data.augment import augment_batch
from mdn_sfm_tpu_torch.data.splits import SplitLine, sample_key
from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch
from mdn_sfm_tpu_torch.masks import NullMaskProvider, PrecomputedMaskProvider, build_mask_provider
from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNBackend, MaskRCNNProvider
from mdn_sfm_tpu_torch.trainer import Trainer
from mdn_sfm_tpu_torch.weights import maskrcnn_state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

H, W = 64, 96


class QuietTrainer(Trainer):
    def _make_writers(self):
        return None


@pytest.fixture(scope="module")
def crafted_pth(tmp_path_factory):
    """A log dir whose model_final_detectron2.pth is the crafted detector."""
    shapes = jax.eval_shape(M.MaskRCNN(max_det=8).init, jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)),
                            jnp.array(64.0), jnp.array(64.0))
    log_dir = str(tmp_path_factory.mktemp("log"))
    torch.save(maskrcnn_state_dict_from_flax(craft_brightness_detector(shapes)),
               os.path.join(log_dir, "model_final_detectron2.pth"))
    return log_dir


def _cfg(**kw) -> Config:
    base = dict(height=H, width=W, batch_size=2, mode=Mode.DS, mask_provider="maskrcnn", d2_max_instances=8,
                d2_infer_scale=2, compute_dtype="float32", threshold=9.22)
    return Config(**{**base, **kw}).validate()


# ------------------------------------------------------------- providers


def _write_masks(d: str) -> list[str]:
    rng = np.random.default_rng(0)
    a = (rng.random((H, W)) < 0.3).astype(np.uint8) * rng.integers(1, 256, (H, W)).astype(np.uint8)
    Image.fromarray(a, mode="L").save(os.path.join(d, "exact.png"))          # any nonzero counts
    small = (rng.random((H // 2 + 3, W // 2 - 5)) < 0.4).astype(np.uint8) * 255
    Image.fromarray(small, mode="L").save(os.path.join(d, "resized.png"))    # BILINEAR of ×255
    rgb = np.zeros((H, W, 3), np.uint8)
    rgb[10:30, 20:60, 1] = 7
    Image.fromarray(rgb, mode="RGB").save(os.path.join(d, "rgb.png"))
    return ["exact", "resized", "missing", "rgb"]


@pytest.mark.parametrize("size", [(H, W), (H // 2, W // 2)])
def test_precomputed_provider_equals_jax(tmp_path, size):
    keys = _write_masks(str(tmp_path))
    got = PrecomputedMaskProvider(str(tmp_path)).union_masks(keys, *size)
    want = JPrecomputed(str(tmp_path)).union_masks(keys, *size)
    assert got.dtype == np.float32 and got.shape == (len(keys),) + size
    np.testing.assert_array_equal(got, want)
    assert not got[2].any() and got[0].any() and got[3].any()


def test_null_and_factory(tmp_path):
    assert not NullMaskProvider().union_masks(["a", "b"], 4, 6).any()
    assert build_mask_provider(Config()) is None
    prov = build_mask_provider(Config(mask_provider="precomputed", mask_dir=str(tmp_path)))
    assert isinstance(prov, PrecomputedMaskProvider) and prov.mask_dir == str(tmp_path)
    with pytest.raises(ValueError, match="unknown mask provider"):
        build_mask_provider(Config(mask_provider="detectron9"))


@pytest.fixture(scope="module")
def provider(crafted_pth):
    return MaskRCNNProvider(_cfg(log_dir=crafted_pth), device="cpu")


def test_provider_builds_the_fast_bf16_model(provider):
    m = provider.model
    assert provider.infer_hw == (2 * H, 2 * W)
    assert (m.pre_nms_topk, m.post_nms_topk, m.box_candidates, m.max_det) == (256, 256, 512, 8)
    assert m.dtype == torch.bfloat16 and m.roi_dtype == torch.bfloat16 and m.score_thresh == 0.3
    assert not m.training


def test_keyed_lookup_raises(provider):
    with pytest.raises(RuntimeError, match="union_masks_from_images"):
        provider.union_masks(["a", "b"], H, W)


def test_missing_weights_fail_fast(tmp_path):
    with pytest.raises(FileNotFoundError, match="model_final_detectron2"):
        MaskRCNNProvider(_cfg(log_dir=str(tmp_path)), device="cpu")
    with pytest.raises(ValueError, match="/64"):
        MaskRCNNProvider(_cfg(log_dir=str(tmp_path), height=96, d2_infer_scale=1, d2_allow_random_weights=True),
                         device="cpu")


def test_random_weights_when_allowed(tmp_path, capsys):
    prov = MaskRCNNProvider(_cfg(log_dir=str(tmp_path), d2_allow_random_weights=True, d2_score_thresh=0.7),
                            device="cpu")
    assert "RANDOM weights" in capsys.readouterr().out and prov.model.score_thresh == 0.7


def test_infer_scale_warning_once(capsys, monkeypatch):
    monkeypatch.setattr(tconfig, "_WARNED_D2_SCALE", False)
    _cfg()
    _cfg(mode=Mode.DC)
    err = capsys.readouterr().err
    assert err.count("d2_infer_scale=2") == 1
    monkeypatch.setattr(tconfig, "_WARNED_D2_SCALE", False)
    _cfg(d2_infer_scale=16)
    _cfg(mask_provider="precomputed")
    assert "WARNING" not in capsys.readouterr().err


# ------------------------------------------------------------ fused step


def _batch(seed: int):
    colors, K = synthetic_batch(2, H, W, seed=seed)
    colors[:, :, 20:44, 30:70] = 230  # a bright object the crafted detector finds
    return {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K)}


@pytest.mark.parametrize("mode", [Mode.DS, Mode.DC])
def test_fused_step_equals_host_mask_step(provider, mode):
    """The step with the provider inside it equals the step fed the masks
    the provider makes from the same augmented target frame."""
    cfg = _cfg(mode=mode, w_d2_sim=0.05)
    batch = _batch(3)
    runs = []
    for fused in (True, False):
        models = T.build_models(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = T.make_optimizer(cfg, models, 10)
        if fused:
            metrics, aux = T.train_step(cfg, models, opt, batch, generator=T.step_generator(1, 0, "cpu"),
                                        provider=provider)
        else:
            _, _, raw0 = augment_batch(cfg, batch["colors_u8"], batch["K"], generator=T.step_generator(1, 0, "cpu"))
            masks = provider.union_masks_from_images(raw0 * 255.0, H, W)
            assert masks.shape == (2, H, W) and masks.any(), "empty masks: the comparison would be vacuous"
            metrics, aux = T.train_step(cfg, models, opt, {**batch, "instance_mask": masks},
                                        generator=T.step_generator(1, 0, "cpu"))
        runs.append({k: float(v) for k, v in metrics.items()})
    assert runs[0] == runs[1]


def test_trainer_fuses_the_live_provider(crafted_pth, tmp_path):
    cfg = _cfg(log_dir=crafted_pth, v_save=f"v{tmp_path.name}", limit_train_samples=2, num_epochs=1,
               num_workers=1, save_frequency=10**6, other_files_path=str(tmp_path))
    tr = QuietTrainer(cfg, synthetic=True, device="cpu")
    assert tr.fused_provider is tr.mask_provider
    arrays, idxs = next(iter(tr.train_loader.iter_batches(0)))
    assert "instance_mask" not in tr._device_batch(arrays, [tr.sample_keys[int(i)] for i in idxs])
    tr.train()
    assert len(tr.sample_history) == 1
    host = QuietTrainer(dataclasses.replace(cfg, d2_fuse_step=False), synthetic=True, device="cpu")
    assert host.fused_provider is None
    batch = host._device_batch(arrays, [host.sample_keys[int(i)] for i in idxs])
    assert batch["instance_mask"].shape == (2, H, W)
    want = host.mask_provider.union_masks_from_images(arrays[0][:, 0], H, W)
    assert torch.equal(batch["instance_mask"], want)


# ------------------------------------------------ precomputed masks, probe


def test_coverage_probe_fails_fast_at_zero_hits(tmp_path, capsys):
    cfg = Config(height=H, width=W, batch_size=2, mode=Mode.DS, mask_provider="precomputed",
                 mask_dir=str(tmp_path / "masks"), limit_train_samples=4, num_workers=1,
                 log_dir=str(tmp_path / "log")).validate()
    with pytest.raises(FileNotFoundError, match="0/4 sample keys"):
        QuietTrainer(cfg, synthetic=True, device="cpu")
    os.makedirs(cfg.mask_dir)
    Image.fromarray(np.full((H, W), 255, np.uint8), mode="L").save(os.path.join(cfg.mask_dir, "1.png"))
    tr = QuietTrainer(cfg, synthetic=True, device="cpu")
    assert "1/4 sample keys covered (25.0%)" in capsys.readouterr().out
    batch = tr._device_batch(next(iter(tr.train_loader.iter_batches(0)))[0], ["1", "0"])
    assert batch["instance_mask"][0].eq(1).all() and not batch["instance_mask"][1].any()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_raw"))
    lines, _ = make_bright_raw_drive(root, h=H, w=W, n_frames=4)
    split_dir = str(tmp_path_factory.mktemp("split"))
    with open(os.path.join(split_dir, "train_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root, split_dir, lines


def test_precompute_masks_writes_the_keys_the_trainer_serves(world, crafted_pth, tmp_path, capsys):
    from mdn_sfm_tpu_torch import precompute_masks as P

    root, split_dir, lines = world
    mask_dir = str(tmp_path / "masks")
    argv = ["--data_path", root, "--split", split_dir, "--mask_dir", mask_dir, "--img_ext", ".png",
            "--weights", os.path.join(crafted_pth, "model_final_detectron2.pth"), "--max_det", "24",
            "--input_hw", "256,384", "--batch", "2", "--device", "cpu"]
    stats = P.main(argv)
    keys = [sample_key(SplitLine.parse(s)) for s in lines]
    assert stats == {"written": len(keys), "skipped": 0, "failed": 0, "empty": 0}
    assert sorted(os.listdir(mask_dir)) == sorted(f"{k}.png" for k in keys)
    assert P.main(argv + ["--limit", "1"])["skipped"] == 1
    assert P.main(argv + ["--overwrite", "--shard_index", "1", "--shard_count", "2"])["written"] == 1

    # each file is the backend's union mask of its target frame
    backend = MaskRCNNBackend(os.path.join(crafted_pth, "model_final_detectron2.pth"), max_det=24,
                              input_hw=(256, 384), device="cpu")
    items = P.manifest_items(root, [SplitLine.parse(s) for s in lines], ".png")
    for key, path in items:
        want = backend.predict_union(np.asarray(Image.open(path).convert("RGB")))
        got = np.asarray(Image.open(os.path.join(mask_dir, f"{key}.png"))) // 255
        np.testing.assert_array_equal(got, want)

    # the port's Trainer finds every key and serves those masks
    cfg = Config(height=H, width=W, batch_size=2, mode=Mode.DS, mask_provider="precomputed", mask_dir=mask_dir,
                 data_path=root, split=split_dir, png=True, num_workers=1, disable_augment=True,
                 log_dir=str(tmp_path / "log"), compute_dtype="float32").validate()
    capsys.readouterr()
    tr = QuietTrainer(cfg, synthetic=False, device="cpu")
    assert f"{len(keys)}/{len(keys)} sample keys covered" in capsys.readouterr().out
    arrays, idxs = next(iter(tr.train_loader.iter_batches(0)))
    batch = tr._device_batch(arrays, [tr.sample_keys[int(i)] for i in idxs])
    for row, i in enumerate(idxs):
        png = np.asarray(Image.open(os.path.join(mask_dir, f"{tr.sample_keys[int(i)]}.png"))) // 255
        np.testing.assert_array_equal(batch["instance_mask"][row].numpy(), png.astype(np.float32))
    assert batch["instance_mask"].any()
    metrics, _ = tr.step_fn(batch, T.step_generator(cfg.seed, 0, "cpu"))
    assert np.isfinite(float(metrics["loss"]))
