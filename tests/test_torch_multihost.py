"""The multi-process contract of the port on the CPU, the counterpart of
``tests/test_multihost.py``: the per-process manifest shards, the launch
end to end (``python -m mdn_sfm_tpu_torch.multihost_dryrun``: two gloo
ranks train, restart and resume), the training entry point under the
launch variables, and no fallback from NCCL."""

import json
import os
import subprocess
import sys

import pytest
import torch

from mdn_sfm_tpu_torch.data.splits import SplitLine, shard_for_host
from mdn_sfm_tpu_torch.parallel import maybe_initialize_distributed, process_count, process_index
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tmp import free_temp_dirs  # noqa: F401  (autouse: the module's temporary files freed at its end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 600


def _env(**kw) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])), **kw)
    for key in ("MDN_COORDINATOR", "MDN_NUM_PROCESSES", "MDN_PROCESS_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        if key not in kw:
            env.pop(key, None)
    return env


class TestShardForHost:
    """``tests/test_multihost.py::TestShardForHost`` on the port's function."""

    def test_disjoint_and_complete(self):
        lines = [SplitLine(f"d{i % 7}", i, "l") for i in range(1001)]
        for host_count in (1, 2, 3, 4):
            shards = [shard_for_host(lines, h, host_count) for h in range(host_count)]
            union = set().union(*(set(s) for s in shards))
            assert sum(len(s) for s in shards) == len(union), "shards overlap"
            dropped = len(lines) - len(union)
            assert 0 <= dropped < host_count
            # equal lengths: every process runs as many steps (one more would
            # wait in an all-reduce the others never reach)
            assert len({len(s) for s in shards}) == 1

    def test_single_host_is_identity(self):
        lines = [SplitLine("d", i, "l") for i in range(10)]
        assert shard_for_host(lines, 0, 1) == lines

    def test_defaults_to_the_process_group(self):
        """Without a group the process is rank 0 of 1: the whole manifest."""
        lines = [SplitLine("d", i, "l") for i in range(10)]
        assert (process_index(), process_count()) == (0, 1)
        assert shard_for_host(lines) == lines


def test_dryrun_end_to_end(tmp_path):
    """Two gloo ranks run the real Trainer for an epoch, then restart with
    resume="auto" for a second: disjoint shards, params bitwise equal on
    both ranks, rank 0 alone writes checkpoints, the restart re-enters at
    the interrupted step and completes."""
    out = subprocess.run([sys.executable, "-m", "mdn_sfm_tpu_torch.multihost_dryrun", "--device", "cpu",
                          "--work_dir", str(tmp_path)],
                         cwd=REPO, env=_env(), capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert out.returncode == 0, f"dryrun failed:\n{out.stdout}\n{out.stderr}"
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["ok"] and result["num_processes"] == 2 and result["device"] == "cpu", result
    for name, passed in result["checks"].items():
        assert passed, f"multi-process contract check failed: {name}"


def test_dryrun_runs_on_the_cards_by_default(tmp_path):
    """Without ``--device`` the dryrun's ranks are NCCL ranks, one a card:
    with fewer cards than ranks it refuses before it starts a worker, and
    names ``--device cpu``; it never falls back to gloo."""
    from mdn_sfm_tpu_torch import multihost_dryrun

    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards are present: the default launch is valid here")
    with pytest.raises(SystemExit, match="2 ranks need 2 cards.*--device cpu"):
        multihost_dryrun.main(["--work_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)  # no worker was started


def test_train_entry_point_under_the_launch_variables(tmp_path):
    """``python -m mdn_sfm_tpu_torch.train --device cpu`` in two processes
    with MDN_COORDINATOR/MDN_NUM_PROCESSES/MDN_PROCESS_ID: both train the
    global batch's halves, rank 0 writes opt.json and the checkpoint."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_dir = str(tmp_path / "log")
    argv = [sys.executable, "-m", "mdn_sfm_tpu_torch.train", "--synthetic", "--device", "cpu", "--num_epochs", "1",
            "--batch_size", "2", "--height", "32", "--width", "64", "--limit_train_samples", "4",
            "--log_frequency", "1", "--num_workers", "1", "--compute_dtype", "float32", "--num_data_shards", "2",
            "--v_save", "vdp", "--log_dir", log_dir]
    procs = [subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env(MDN_COORDINATOR=f"127.0.0.1:{port}", MDN_NUM_PROCESSES="2",
                                       MDN_PROCESS_ID=str(r)))
             for r in range(2)]
    logs = [p.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
        # 2 samples a rank: two steps of the global batch of 2, one sample each
        assert sum(ln.startswith("epoch 0 | batch") for ln in log.splitlines()) == 2, log
    losses = [[ln.split("loss: ")[1].split()[0] for ln in log.splitlines() if ln.startswith("epoch 0 | batch")]
              for log in logs]
    assert losses[0] == losses[1]  # the group's mean, read on both ranks
    models = os.path.join(log_dir, "vdp", "models")
    assert os.path.exists(os.path.join(models, "opt.json"))
    assert sorted(os.listdir(os.path.join(models, "weights_0"))) == ["adam.pth", "meta.json", "mobile_decoder.pth"]


def test_nccl_without_cuda_raises(monkeypatch):
    """The launch variables with the card's default device on a machine
    without CUDA raise; nothing falls back to gloo or the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: NCCL is the valid default here")
    monkeypatch.setenv("MDN_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MDN_NUM_PROCESSES", "2")
    monkeypatch.setenv("MDN_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        maybe_initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_no_launch_variables_no_group(monkeypatch):
    for key in ("MDN_COORDINATOR", "MDN_NUM_PROCESSES", "MDN_PROCESS_ID", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert maybe_initialize_distributed("cpu") is False  # one process: no group, as in JAX
    assert not torch.distributed.is_initialized()
