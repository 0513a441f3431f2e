"""The port's Trainer on the CPU, on synthetic data and on a KITTI fixture:
the epoch loop, the reference checkpoint layout, manual and automatic
resume (an interrupted-then-resumed run is bitwise equal to an
uninterrupted one), the SIGTERM checkpoint, the no-op restart, the async
save, inline validation, the profiler and the two tools — the counterparts
of ``tests/test_trainer.py``'s tests of the JAX Trainer."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from fixtures import make_kitti2015, make_raw_drive
from mdn_sfm_tpu_torch import checkpoints as ckpt
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


class QuietTrainer(Trainer):
    """No TensorBoard writers: importing tensorboard costs seconds a process,
    and only one test below needs them."""

    def _make_writers(self):
        return None


def make_cfg(tmp, **kw):
    base = dict(height=32, width=64, batch_size=2, num_epochs=1, num_workers=1, save_frequency=4,
                log_frequency=100, compute_dtype="float32", log_dir=os.path.join(tmp, "log"),
                other_files_path=os.path.join(tmp, "files"), v_save="vtest", w_d2_sim=0.0,
                limit_train_samples=16)
    base.update(kw)
    return Config(**base).validate()


def trainer(cfg, cls=QuietTrainer):
    return cls(cfg, synthetic=True, device="cpu")


def mobile(t):
    return {k: v.clone() for k, v in t.models.mobile.state_dict().items()}


def assert_equal_sd(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def assert_equal_adam(o1, o2):
    assert o1.count == o2.count
    for a, b in zip(o1.mu + o1.nu, o2.mu + o2.nu):
        assert torch.equal(a, b)


def stop_after(t, n):
    """Set the flag the SIGTERM handler sets once ``n`` steps have run."""
    inner = t.step_fn

    def step(batch, generator):
        out = inner(batch, generator)
        if len(t.sample_history) == n:
            t._stop_requested = True
        return out

    t.step_fn = step


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trainer"))
    cfg = make_cfg(tmp)
    t = trainer(cfg)
    t.train()
    return tmp, cfg, t


def models_dir(cfg, v="vtest"):
    return os.path.join(cfg.log_dir, v, "models")


def weights(cfg, v="vtest"):
    return sorted(int(d.split("_")[1]) for d in os.listdir(models_dir(cfg, v)) if d.startswith("weights_"))


class TestTrainLoop:
    def test_checkpoints_written_in_reference_layout(self, trained):
        _, cfg, t = trained
        assert os.path.exists(os.path.join(models_dir(cfg), "opt.json"))
        assert weights(cfg) == [0, 1, 2]  # after steps 4 and 8, and at the end
        for idx, step in zip((0, 1, 2), (4, 8, 8)):
            folder = ckpt.weights_folder(cfg.log_dir, "vtest", idx)
            assert sorted(os.listdir(folder)) == ["adam.pth", "meta.json", "mobile_decoder.pth"]
            assert ckpt.read_meta(folder) == {"step": step, "base_step": 0}
        assert [s["async"] for s in t.save_seconds] == [True, True, False]

    def test_opt_json_loads_back_in_both_packages(self, trained):
        from mdn_sfm_tpu.config import Config as JConfig

        _, cfg, _ = trained
        path = os.path.join(models_dir(cfg), "opt.json")
        for loaded in (Config.load(path), JConfig.load(path)):
            assert loaded.height == cfg.height and loaded.mode.value == cfg.mode.value

    def test_steps_advanced_and_losses_finite(self, trained):
        _, _, t = trained
        assert t.step == t.steps_per_epoch == 8 and t.opt.count == 8
        assert [s for s, _ in t.sample_history] == list(range(8))
        assert len(t.step_log) == 1 and np.isfinite(t.step_log[0][2])  # log_frequency 100: batch 0

    def test_epoch_takes_every_sample_once(self, trained):
        _, _, t = trained
        seen = sorted(i for _, idxs in t.sample_history for i in idxs)
        assert seen == list(range(16))

    def test_last_checkpoint_equals_the_trainer(self, trained):
        _, cfg, t = trained
        folder = ckpt.weights_folder(cfg.log_dir, "vtest", 2)
        sd, adam, step = ckpt.load_checkpoint(folder, {"mobile_decoder": mobile(t)}, ("mobile_decoder",),
                                              load_adam=True)
        assert step == 8
        assert_equal_sd(sd["mobile_decoder"], t.models.mobile.state_dict())
        opt = T.make_optimizer(cfg, t.models, t.steps_per_epoch)
        opt.load_state_dict(adam)
        assert_equal_adam(opt, t.opt)

    def test_resume_with_load_adam(self, trained):
        _, cfg, t = trained
        cfg2 = dataclasses.replace(cfg, load_adam=True, v_load="vtest", idx_load=weights(cfg)[-1], v_save="vload")
        t2 = trainer(cfg2)
        assert t2.start_step == t2.base_step == 8 and t2.step == 8
        assert_equal_sd(mobile(t2), t.models.mobile.state_dict())
        assert_equal_adam(t2.opt, t.opt)


class TestAutoResume:
    def test_auto_resume_continues_from_latest(self, trained):
        _, cfg, t = trained
        t2 = trainer(dataclasses.replace(cfg, resume="auto"))
        assert t2.start_step == 8 and t2.start_idx_save == weights(cfg)[-1] + 1
        assert t2.step == 8 and t2.base_step == 0
        assert_equal_sd(mobile(t2), t.models.mobile.state_dict())
        assert_equal_adam(t2.opt, t.opt)

    def test_auto_resume_fresh_start_when_no_checkpoint(self, tmp_path):
        t = trainer(make_cfg(str(tmp_path), resume="auto", v_save="vfresh"))
        assert t.start_step == 0 and t.start_idx_save == 0 and t.opt.count == 0

    def test_interrupted_resume_matches_uninterrupted(self, tmp_path):
        """Interrupt mid-epoch 0, auto-resume, finish: the same batches in the
        same order, and bitwise the same params and Adam state as a run that
        was not interrupted (the shuffle depends on (seed, epoch), the
        augmentation on (seed, step), and the LR on Adam's restored count)."""
        kw = dict(num_epochs=2, save_frequency=10**6, limit_train_samples=8)
        tA = trainer(make_cfg(str(tmp_path / "a"), **kw))
        tA.train()
        assert tA.step == 2 * tA.steps_per_epoch == 8

        tB = trainer(make_cfg(str(tmp_path / "b"), **kw))
        stop_after(tB, 3)
        tB.train()
        assert tB.step == 3
        tB2 = trainer(make_cfg(str(tmp_path / "b"), resume="auto", **kw))
        assert tB2.start_step == 3
        tB2.train()
        assert tB2.step == 8
        assert tB.sample_history + tB2.sample_history == tA.sample_history
        assert_equal_sd(mobile(tB2), mobile(tA))
        assert_equal_adam(tB2.opt, tA.opt)

    def test_augmentation_draws_depend_only_on_seed_and_step(self):
        def draw(seed, step):
            return torch.rand(4, generator=T.step_generator(seed, step, "cpu"))

        assert torch.equal(draw(42, 7), draw(42, 7))
        assert not torch.equal(draw(42, 7), draw(42, 8))
        assert not torch.equal(draw(42, 7), draw(43, 7))

    def test_sigterm_checkpoints_and_exits(self, tmp_path):
        """SIGTERM mid-epoch: the loop stops at the next batch boundary and
        train() returns after writing a checkpoint."""
        cfg = make_cfg(str(tmp_path), v_save="vsig", num_epochs=5, save_frequency=10_000)
        t = trainer(cfg)
        inner = t.step_fn
        calls = []

        def step_then_sigterm(batch, generator):
            calls.append(1)
            if len(calls) == 2:
                signal.raise_signal(signal.SIGTERM)
            return inner(batch, generator)

        t.step_fn = step_then_sigterm
        prev = signal.getsignal(signal.SIGTERM)
        t.train()  # returns, does not die
        assert signal.getsignal(signal.SIGTERM) == prev  # handler restored
        assert len(calls) == 2 and t.step == 2
        latest = ckpt.latest_weights_idx(cfg.log_dir, "vsig")
        with open(os.path.join(ckpt.weights_folder(cfg.log_dir, "vsig", latest), "meta.json")) as f:
            assert json.load(f)["step"] == 2

    def test_auto_resume_after_fine_tune_inherits_base_step(self, tmp_path):
        """A --load_adam stage continues its base checkpoint's step counter;
        auto-resume positions itself by step - base_step."""
        kw = dict(num_epochs=2, save_frequency=10**6, limit_train_samples=8)
        t1 = trainer(make_cfg(str(tmp_path), v_save="vs1", **kw))
        t1.train()
        base = t1.step
        assert base == 2 * t1.steps_per_epoch

        cfg2 = make_cfg(str(tmp_path), v_save="vs2", load_adam=True, v_load="vs1",
                        idx_load=ckpt.latest_weights_idx(os.path.join(str(tmp_path), "log"), "vs1"), **kw)
        t2 = trainer(cfg2)
        assert t2.start_step == base and t2.base_step == base
        stop_after(t2, 3)
        t2.train()

        t3 = trainer(dataclasses.replace(cfg2, resume="auto"))
        assert t3.start_step == base + 3 and t3.base_step == base
        t3.train()
        assert t3.step == base + 2 * t3.steps_per_epoch
        assert [s for s, _ in t2.sample_history + t3.sample_history] == list(range(base, t3.step))

    def test_restart_of_complete_run_is_noop(self, tmp_path):
        cfg = make_cfg(str(tmp_path), v_save="vdone", save_frequency=10**6, limit_train_samples=8)
        trainer(cfg).train()
        before = weights(cfg, "vdone")
        t = trainer(dataclasses.replace(cfg, resume="auto"))
        t.train()
        assert weights(cfg, "vdone") == before and t.sample_history == []

    def test_async_save_failure_surfaces(self, trained, monkeypatch):
        _, _, t = trained

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(ckpt, "save_checkpoint", boom)
        t.save_model(99, async_write=True)
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            t._join_pending_save()
        t._join_pending_save()  # the error is consumed; the trainer stays usable

    def test_async_save_writes_the_snapshot_not_later_updates(self, tmp_path):
        """The background write serializes a copy taken when save_model was
        called: updating the params in place right after changes nothing on
        disk. Back-to-back saves are ordered and complete."""
        cfg = make_cfg(str(tmp_path), v_save="vasync", limit_train_samples=4)
        t = trainer(cfg)
        snap = mobile(t)
        t.save_model(2, async_write=True)
        with torch.no_grad():
            for p in t.models.mobile.parameters():
                p.add_(1.0)
        t.save_model(3, async_write=True)
        t._join_pending_save()
        for idx, want in ((2, snap), (3, mobile(t))):
            folder = ckpt.weights_folder(cfg.log_dir, "vasync", idx)
            sd, _, _ = ckpt.load_checkpoint(folder, {"mobile_decoder": snap}, ("mobile_decoder",))
            assert_equal_sd(sd["mobile_decoder"], want)
            assert os.path.exists(os.path.join(folder, "adam.pth"))


class TestOptions:
    def test_default_device_is_cuda_and_raises_without_it(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid here")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            QuietTrainer(make_cfg(str(tmp_path)), synthetic=True)

    def test_debug_nans_turns_on_anomaly_mode(self, tmp_path):
        try:
            QuietTrainer(make_cfg(str(tmp_path)), synthetic=True, debug_nans=True, device="cpu")
            assert torch.is_anomaly_enabled()
        finally:
            torch.autograd.set_detect_anomaly(False)

    def test_profile_dir_traces_steps_10_to_15(self, tmp_path):
        prof = str(tmp_path / "prof")
        t = trainer(make_cfg(str(tmp_path), profile_dir=prof, limit_train_samples=34, save_frequency=10**6))
        t.train()
        assert t.step == 17 and os.listdir(prof) == ["trace_step15.json"]


class TestTools:
    def test_epipolar_statics(self, trained):
        _, cfg, t = trained
        thresholds = t.epipolar_statics(num_quantile=50, max_batches=2)
        assert thresholds.shape == (8,) and np.all(np.diff(thresholds) >= 0)
        pct = np.load(os.path.join(cfg.other_files_path, "eigen_zhou_percentiles.npy"))
        assert pct.shape == (2, 50, 4)  # (frames, quantiles, 2 batches × 2 images)
        assert np.all(np.diff(pct, axis=1) >= 0) and np.all(pct >= 0)
        np.testing.assert_allclose(np.loadtxt(os.path.join(cfg.other_files_path, "eigen_zhou_thresholds")),
                                   thresholds)

    def test_hyperparameter_try(self, trained):
        _, _, t = trained
        before = mobile(t)
        results = t.hyperparameter_try("alpha", [0.1, 0.9], batches_per_value=2)
        assert set(results) == {0.1, 0.9} and all(np.isfinite(v) for v in results.values())
        assert results[0.1] != results[0.9]
        assert_equal_sd(mobile(t), before)  # the trainer's own models are untouched


def test_kitti_training_with_inline_val_and_tensorboard(tmp_path):
    """The KITTI raw path through the split manifests (an absolute split
    directory), inline validation on a KITTI-2015 fixture, and TensorBoard
    scalars and images from both."""
    pytest.importorskip("torch.utils.tensorboard")
    raw, k15 = str(tmp_path / "raw"), str(tmp_path / "k15")
    lines = make_raw_drive(raw, n_frames=6, h=48, w=96)
    make_kitti2015(k15, n=2)
    split = tmp_path / "split"
    split.mkdir()
    (split / "train_files.txt").write_text("\n".join(lines) + "\n")
    cfg = make_cfg(str(tmp_path), split=str(split), data_path=raw, data_root=k15, limit_train_samples=0,
                   log_frequency=1, mode="TG", threshold=9.22)
    t = Trainer(cfg, device="cpu")
    assert t.writers is not None and t.val_dataset is not None
    assert t.sample_keys == [f"2011_09_26_2011_09_26_drive_0001_sync_{i}_l" for i in range(1, 5)]
    t.train()
    assert t.step == 2 and t._val_idx == 1 and len(t.step_log) == 2
    for w in t.writers.values():
        w.flush()
    for sub in ("tb_train", "tb_val"):
        files = os.listdir(os.path.join(cfg.log_dir, "vtest", sub))
        assert files and os.path.getsize(os.path.join(cfg.log_dir, "vtest", sub, files[0])) > 1000, sub
