"""The port's Trainer at ``steps_per_dispatch = 4`` on the CPU: it trains
and saves where the step counter crosses a multiple of save_frequency, the
epoch's tail batches go through the single step, a stop during that flush
halts at the next batch boundary, a stopped run resumes at the right sample,
and the params land where a ``steps_per_dispatch = 1`` Trainer's land on the
same data — the counterparts of ``tests/test_trainer.py::TestMultiDispatch``."""

import os

import pytest
import torch

from mdn_sfm_tpu_torch import checkpoints as ckpt
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

K = 4


class QuietTrainer(Trainer):
    """No TensorBoard writers (importing tensorboard costs seconds)."""

    def _make_writers(self):
        return None


def make_cfg(tmp, v_save, **kw):
    # 20 samples / batch 2 = 10 batches: two dispatches of 4 and a tail of 2
    base = dict(height=32, width=64, batch_size=2, num_epochs=1, num_workers=1, save_frequency=3,
                log_frequency=100, compute_dtype="float32", log_dir=os.path.join(tmp, "log"),
                other_files_path=os.path.join(tmp, "files"), v_save=v_save, w_d2_sim=0.0,
                limit_train_samples=20, steps_per_dispatch=K)
    base.update(kw)
    return Config(**base).validate()


def counted(t):
    """Count the trainer's dispatches and single steps."""
    calls = {"multi": 0, "single": 0}
    multi, single = t.multi_fn, t.step_fn

    def multi_fn(*a):
        calls["multi"] += 1
        return multi(*a)

    def step_fn(*a):
        calls["single"] += 1
        return single(*a)

    t.multi_fn, t.step_fn = multi_fn, step_fn
    return calls


def params(t):
    return {k: v.clone() for k, v in t.models.mobile.state_dict().items()}


def assert_equal_sd(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A K = 4 run and a K = 1 run of the same epoch."""
    tmp = str(tmp_path_factory.mktemp("kstep"))
    tk = QuietTrainer(make_cfg(tmp, "vk"), synthetic=True, device="cpu")
    calls = counted(tk)
    tk.train()
    t1 = QuietTrainer(make_cfg(tmp, "v1", steps_per_dispatch=1), synthetic=True, device="cpu")
    t1.train()
    return tmp, tk, calls, t1


def test_dispatches_then_flushes_the_tail_through_single_steps(runs):
    _, tk, calls, _ = runs
    assert calls == {"multi": 2, "single": 2}
    assert tk.step == tk.opt.count == 10
    assert [s for s, _ in tk.sample_history] == list(range(10))


def test_saves_where_the_step_crosses_save_frequency(runs):
    tmp, tk, _, _ = runs
    log = os.path.join(tmp, "log")
    # crossings of 3, 6 and 9 after the dispatches to 4 and 8 and the tail
    # step to 9, then the end of the run
    steps = [ckpt.read_meta(ckpt.weights_folder(log, "vk", i))["step"] for i in range(4)]
    assert steps == [4, 8, 9, 10]
    assert ckpt.latest_weights_idx(log, "vk") == 3
    assert [s["async"] for s in tk.save_seconds] == [True, True, True, False]


def test_params_equal_a_single_step_trainer(runs):
    """On the CPU a dispatch runs its K steps in turn: the same batches,
    draws and params as K = 1, bit for bit."""
    _, tk, _, t1 = runs
    assert tk.sample_history == t1.sample_history
    assert_equal_sd(params(tk), params(t1))
    for a, b in zip(tk.opt.mu + tk.opt.nu, t1.opt.mu + t1.opt.nu):
        assert torch.equal(a, b)


def test_stop_during_the_tail_flush_halts_at_the_next_batch(tmp_path):
    """12 samples / batch 2 = 6 batches: one dispatch of 4, a tail of 2. A
    stop after the first tail step leaves the second unstepped."""
    t = QuietTrainer(make_cfg(str(tmp_path), "vstop", limit_train_samples=12, save_frequency=10**6),
                     synthetic=True, device="cpu")
    single = t.step_fn

    def stop_after_first(*a):
        out = single(*a)
        t._stop_requested = True  # what the SIGTERM handler sets
        return out

    t.step_fn = stop_after_first
    t.train()
    assert t.step == t.opt.count == 5
    assert ckpt.read_meta(ckpt.weights_folder(t.cfg.log_dir, "vstop", 0))["step"] == 5


def test_stopped_run_resumes_at_the_right_sample(runs, tmp_path):
    """A run stopped after its first dispatch checkpoints at step 4; resumed
    with resume="auto" it takes the uninterrupted run's batches from there
    and lands on its params bit for bit."""
    _, tk, _, _ = runs
    t = QuietTrainer(make_cfg(str(tmp_path), "vk"), synthetic=True, device="cpu")
    multi = t.multi_fn

    def stop_after_dispatch(*a):
        out = multi(*a)
        t._stop_requested = True
        return out

    t.multi_fn = stop_after_dispatch
    t.train()
    assert t.step == 4 and t.idx_save == 1  # the crossing of 3, then the stop's checkpoint
    resumed = QuietTrainer(make_cfg(str(tmp_path), "vk", resume="auto"), synthetic=True, device="cpu")
    assert resumed.start_step == 4 and resumed.opt.count == 4
    resumed.train()
    assert t.sample_history + resumed.sample_history == tk.sample_history
    assert_equal_sd(params(resumed), params(tk))
