"""What the PyTorch port promises besides numbers: it imports neither JAX
nor the JAX package, its config reads the JAX package's options, the
behaviours it does not have yet raise, and its entry points default to the
card and refuse to fall back to the CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from mdn_sfm_tpu import config as jc
from mdn_sfm_tpu_torch import config as tc
from mdn_sfm_tpu_torch.utils import resolve_device
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the Trainer's slice: checkpoints, the KITTI data path and the host helpers
NEW_MODULES = ("trainer", "checkpoints", "native", "labels", "metrics", "viz", "data.splits",
               "data.kitti", "data.loader", "data.cache", "data.eval_datasets")
# the eval slice: the four eval CLIs and the README-table harness
EVAL_CLIS = ("evaluate_mix", "evaluate_mask", "evaluate_flow", "evaluate_pose", "reproduce_readme_table")
# the DS/DC slice: the mask providers, the Mask R-CNN and its two kernels
MASK_MODULES = ("masks", "masks.providers", "masks.maskrcnn", "precompute_masks", "ops.nms", "ops.roi_align")
# the step options' slice: the synthetic rehearsal and its crafted detector
REHEARSAL_MODULES = ("synthetic_e2e", "masks.crafted")
# the data-parallel slice: the process group, the step's all-reduce, the
# multi-process launch check
PARALLEL_MODULES = ("parallel", "parallel.distributed", "parallel.data_parallel", "multihost_dryrun")
# the tooling slice: the instance-segmentation catalog, the synthetic
# writers, the GT and scale tools, and the bench tools
TOOLING_MODULES = ("masks.dataset", "data.worlds", "generate_mobile_gt", "quantify_d2_scale", "bench_e2e",
                   "bench_eval", "bench_loader", "bench_precompute")
# the serving and measurement slice: the forward's export, the step's
# roofline, the batch-scaling study
SERVING_MODULES = ("export_model", "roofline", "bench_scaling")
# the tools that run on a device, with arguments that make them cheap to refuse
DEVICE_TOOLS = {"quantify_d2_scale": [], "bench_e2e": ["--n_items", "1"], "bench_eval": ["--n", "1"],
                "bench_precompute": ["--n", "1"], "generate_mobile_gt": ["--phase", "predict"],
                "export_model": ["--height", "32", "--width", "64"], "roofline": ["--k_steps", "1"],
                "bench_scaling": ["--bs", "2", "--k", "1"]}


def _run(*args: str, timeout: int = 300):
    # one torch thread a subprocess, as the test workers run beside each other
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port and chip_smoke.py import with jax, flax,
    optax and mdn_sfm_tpu made unimportable."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'mdn_sfm_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import mdn_sfm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(mdn_sfm_tpu_torch.__path__, 'mdn_sfm_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "from mdn_sfm_tpu_torch import native\n"
        "native.lib()\n"
        "assert native.imgio_available()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'mdn_sfm_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    res = _run("-c", code)
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    assert len(names) >= 25
    assert {f"mdn_sfm_tpu_torch.{m}"
            for m in NEW_MODULES + EVAL_CLIS + MASK_MODULES + REHEARSAL_MODULES + PARALLEL_MODULES
            + TOOLING_MODULES + SERVING_MODULES} <= names


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    res = _run("chip_smoke.py", timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_train_cli_refuses_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    res = _run("-c", "from mdn_sfm_tpu_torch.train import main; main(['--synthetic', '--limit_train_samples', '4'])")
    assert res.returncode != 0 and "CUDA is not available" in res.stderr


@pytest.mark.parametrize("cli", EVAL_CLIS)
def test_eval_cli_refuses_silent_cpu_fallback(cli, tmp_path):
    """Without --device an eval CLI runs on the card or raises before it
    reads anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    argv = ["--mode_versions", "SN=v1:0"] if cli == "reproduce_readme_table" else []
    res = _run("-m", f"mdn_sfm_tpu_torch.{cli}", "--data_root", str(tmp_path), *argv)
    assert res.returncode != 0 and "CUDA is not available" in res.stderr


def test_train_cli_runs_on_cpu_when_asked(tmp_path):
    """Trains, logs every step and writes the reference checkpoint layout."""
    log_dir = str(tmp_path / "log")
    res = _run(
        "-m", "mdn_sfm_tpu_torch.train", "--synthetic", "--device", "cpu", "--num_epochs", "1",
        "--batch_size", "2", "--height", "64", "--width", "96", "--save_frequency", "4",
        "--v_save", "vtest", "--limit_train_samples", "10", "--mode", "TG", "--w_d2_sim", "0",
        "--log_frequency", "1", "--num_workers", "1", "--log_dir", log_dir,
    )
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("epoch 0 | batch")]
    assert len(lines) == 5 and all("loss: " in ln for ln in lines)
    models = os.path.join(log_dir, "vtest", "models")
    assert os.path.exists(os.path.join(models, "opt.json"))
    for idx in (0, 1):  # after step 4, and the end of the run
        for f in ("mobile_decoder.pth", "adam.pth", "meta.json"):
            assert os.path.exists(os.path.join(models, f"weights_{idx}", f)), (idx, f)


def test_config_fields_and_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jc.Config)}
    tf = {f.name: f.default for f in dataclasses.fields(tc.Config)}
    assert tf.keys() == jf.keys()
    for k in jf:
        assert (tf[k].value if isinstance(tf[k], tc.Mode) else tf[k]) == \
               (jf[k].value if isinstance(jf[k], jc.Mode) else jf[k]), k


def test_opt_json_reads_in_both(tmp_path):
    path = str(tmp_path / "opt.json")
    jcfg = jc.Config(height=192, width=640, mode=jc.Mode.TG, threshold=9.22, scales=(0, 1, 2, 3))
    jcfg.save(path)
    cfg = tc.Config.load(path)
    assert cfg.mode == tc.Mode.TG and (cfg.height, cfg.width) == (192, 640)
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())


def test_train_flags_match_jax():
    argv = ["--mode", "TG", "--height", "192", "--width", "640", "--threshold", "9.22",
            "--w_d2_sim", "0", "--scales", "0", "1", "--disable_min"]
    t = tc.parse_train_config(argv)
    j = jc.parse_train_config(argv)
    assert json.loads(t.to_json()) == json.loads(j.to_json())


def _flags(add_args) -> dict:
    import argparse

    parser = argparse.ArgumentParser()
    add_args(parser)
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const, a.choices, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


def test_eval_flags_match_jax():
    """The eval flags: the same names, defaults and kinds, and the same
    config from the same argv."""
    assert _flags(tc.add_eval_args) == _flags(jc.add_eval_args)
    argv = ["--mode", "TG", "--height", "192", "--width", "640", "--version", "v3", "--idx", "14",
            "--binary_threshold", "0.3", "--eval_batch_size", "8", "--scales", "0", "1",
            "--save_pred_masks", "--pred_errors", "--compute_dtype", "float32"]
    assert json.loads(tc.parse_eval_config(argv).to_json()) == json.loads(jc.parse_eval_config(argv).to_json())
    cfg, device = tc.parse_eval_cli("eval", argv + ["--device", "cpu"])
    assert device == "cpu" and json.loads(cfg.to_json()) == json.loads(jc.parse_eval_config(argv).to_json())
    assert tc.parse_eval_cli("eval", [])[1] == "cuda"


@pytest.mark.parametrize("field,value", [("num_data_shards", 2)])
def test_unimplemented_options_raise(field, value, tmp_path):
    """One process driving several devices is not the port's: the option
    validates (it counts the ranks of a process group), and a Trainer whose
    process has no group of that size refuses it by name."""
    from mdn_sfm_tpu_torch.trainer import Trainer

    cfg = tc.Config(**{field: value}, log_dir=str(tmp_path)).validate()
    assert getattr(cfg, field) == value
    with pytest.raises(ValueError, match=field):
        Trainer(cfg, synthetic=True, device="cpu")
    with pytest.raises(ValueError, match=field):
        tc.Config(**{field: -1}).validate()


@pytest.mark.parametrize(
    "field,value",
    [("remat", True), ("accum_steps", 2), ("fine_tune_flow_motion", True), ("bn_frozen_eval", False),
     ("skip_nonfinite_updates", True), ("use_pallas_epipolar", False), ("steps_per_dispatch", 2)],
)
def test_step_options_validate_and_read_from_the_flags(field, value):
    """The step options are the port's too: each validates, and the train
    flags (``use_pallas_epipolar`` has none) set it as the JAX package's
    flags do (``--steps_per_dispatch 2``: K steps a dispatch)."""
    assert getattr(tc.Config(**{field: value}).validate(), field) == value
    if field not in jc._TRAIN_FIELDS:
        return
    argv = [f"--{field}"] if isinstance(value, bool) and value else [f"--{field}", str(value)]
    assert json.loads(tc.parse_train_config(argv).to_json()) == json.loads(jc.parse_train_config(argv).to_json())


def test_synthetic_e2e_refuses_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    res = _run("-m", "mdn_sfm_tpu_torch.synthetic_e2e", "--modes", "SN", "--steps1", "1", "--steps2", "1")
    assert res.returncode != 0 and "CUDA is not available" in res.stderr and '"modes"' not in res.stdout


def test_synthetic_e2e_runs_on_cpu_when_asked(tmp_path):
    res = _run("-m", "mdn_sfm_tpu_torch.synthetic_e2e", "--device", "cpu", "--modes", "SN", "--height", "32",
               "--width", "64", "--batch_size", "2", "--eval_batch", "2", "--steps1", "1", "--steps2", "1",
               "--k_steps", "1", "--log_dir", str(tmp_path))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(out["modes"]) == ["SN"] and out["modes"]["SN"]["steps2"] == 1


@pytest.mark.parametrize("provider", ["none", "precomputed", "maskrcnn"])
def test_mask_provider_options_validate(provider):
    """The DS/DC mask providers are the port's too: every value the JAX
    package takes validates."""
    assert tc.Config(mask_provider=provider).validate().mask_provider == provider


def test_precompute_masks_cli_refuses_silent_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    res = _run("-m", "mdn_sfm_tpu_torch.precompute_masks", "--data_path", str(tmp_path), "--allow_random_weights",
               "--limit", "1")
    assert res.returncode != 0 and "CUDA is not available" in res.stderr


@pytest.mark.parametrize("tool", sorted(DEVICE_TOOLS))
def test_device_tools_refuse_silent_cpu_fallback(tool, tmp_path, monkeypatch):
    """Without --device a tool that touches the device runs on the card or
    raises before it writes anything in the working directory
    (bench_loader is host-only, as the JAX tool is)."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"mdn_sfm_tpu_torch.{tool}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(DEVICE_TOOLS[tool])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("kw", [dict(height=100), dict(frame_ids=(1, 0, -1)), dict(compute_dtype="float16")])
def test_invalid_config_raises(kw):
    with pytest.raises(ValueError):
        tc.Config(**kw).validate()
