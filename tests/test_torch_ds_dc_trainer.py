"""A DS run of the port's Trainer on precomputed fixture masks against the
JAX package's Trainer on the CPU: the same carried weights (exported with
``export_pth``), the same synthetic data and batch order, the same
``{mask_dir}/{key}.png`` union masks served by each package's
``PrecomputedMaskProvider`` under the Trainer's sample keys,
``disable_augment``, float32 and ``num_data_shards=1``. Per-step losses
must agree at ``tests/test_torch_train_step.py``'s tolerances."""

import os

import jax
import numpy as np
import pytest
from PIL import Image

from mdn_sfm_tpu import checkpoints as JC
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu.config import Mode as JMode
from mdn_sfm_tpu.trainer import Trainer as JTrainer
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

STEPS = 3
SAMPLES = 2 * STEPS
LOSS_RTOL = (1e-5, 3e-5, 3e-5)  # tests/test_torch_trainer_parity.py
H, W = 32, 64


class QuietTrainer(Trainer):
    def _make_writers(self):
        return None


class QuietJTrainer(JTrainer):
    def _make_writers(self):
        return None


def _write_fixture_masks(mask_dir: str) -> None:
    """Union masks for the synthetic keys 0..SAMPLES-2 (the last key has none
    and trains with zeros), some at half size."""
    os.makedirs(mask_dir)
    rng = np.random.default_rng(4)
    for i in range(SAMPLES - 1):
        h, w = (H, W) if i % 2 else (H // 2, W // 2)
        m = np.zeros((h, w), np.uint8)
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        m[y:y + h // 2, x:x + w // 3] = 255
        Image.fromarray(m, mode="L").save(os.path.join(mask_dir, f"{i}.png"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ds_parity"))
    log_dir, mask_dir = os.path.join(tmp, "log"), os.path.join(tmp, "masks")
    _write_fixture_masks(mask_dir)
    kw = dict(height=H, width=W, batch_size=2, num_epochs=1, num_workers=1, log_frequency=100,
              save_frequency=10**6, compute_dtype="float32", threshold=9.22, w_d2_sim=0.05,
              ds_similarity_term=True, disable_augment=True, limit_train_samples=SAMPLES, load_adam=True,
              v_load="vinit", idx_load=0, num_data_shards=1, mask_provider="precomputed", mask_dir=mask_dir,
              log_dir=log_dir)
    jt = QuietJTrainer(JConfig(v_save="vjax", donate_state=False, other_files_path=os.path.join(tmp, "fj"),
                               mode=JMode.DS, **kw).validate(), synthetic=True)
    variables = jax.device_get({**jt.frozen, "mobile_decoder": {"params": jt.state.params["mobile_decoder"]}})
    for folder, nets in ((JC.weights_folder(log_dir, "v0", 0), ("flownet", "posenet")),
                         (JC.weights_folder(log_dir, "vinit", 0), ("mobile_decoder",))):
        for n in nets:
            JC.export_pth(os.path.join(folder, f"{n}.pth"), n, variables[n])

    out = {"jax": [], "port": []}

    def record(t, key, jax_side):
        inner = t.step_fn

        def step(*args):
            res = inner(*args)
            batch = args[2] if jax_side else args[0]
            out[key].append(({k: float(v) for k, v in (res[2] if jax_side else res[0]).items()},
                             np.asarray(batch["instance_mask"])))
            return res

        t.step_fn = step

    record(jt, "jax", True)
    jt.train()
    tt = QuietTrainer(Config(v_save="vport", other_files_path=os.path.join(tmp, "fp"), mode="DS", **kw).validate(),
                      synthetic=True, device="cpu")
    record(tt, "port", False)
    tt.train()
    return jt, tt, out


def test_same_batches_and_masks(runs):
    jt, tt, out = runs
    jt.train_loader.epoch = 0
    assert [idxs for _, idxs in tt.sample_history] == [[int(i) for i in idxs] for _, idxs in jt.train_loader]
    assert len(out["jax"]) == len(out["port"]) == STEPS
    for (_, jm), (_, tm) in zip(out["jax"], out["port"]):
        np.testing.assert_array_equal(tm, jm)
    assert any(m.any() for _, m in out["port"]) and not all(m.all() for _, m in out["port"])


@pytest.mark.parametrize("step", range(STEPS))
def test_per_step_losses_match_jax(runs, step):
    _, _, out = runs
    jm, tm = out["jax"][step][0], out["port"][step][0]
    assert set(tm) == set(jm)
    for k in jm:
        assert np.isfinite(tm[k]), k
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL[step], err_msg=k)
