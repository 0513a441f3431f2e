"""The port's scaling study (``mdn_sfm_tpu_torch.bench_scaling``, the
counterpart of ``tools/bench_scaling.py``) on the CPU: a row at 32×64, batch
2, K = 2 has the JAX tool's row keys (its memory fields null off the card,
its device named), a row that runs out of device memory becomes an error
row while any other error propagates, and the flags are the JAX tool's plus
``--device``. The row's numbers are CPU times and stand for nothing on the
card. About 10 s on one worker."""

import pytest
import torch

from mdn_sfm_tpu_torch import bench_scaling as S
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tool_flags import defaults, jax_parser

# tools/bench_scaling.py's row keys, with its memory analysis
JAX_ROW = {"mode", "bs", "remat", "accum", "fine_tune", "frames_per_s", "ms_per_step", "hbm_temp", "hbm_args",
           "hbm_out"}
JAX_ERROR_ROW = {"mode", "bs", "remat", "accum", "fine_tune", "error"}
ARGV = ["--device", "cpu", "--height", "32", "--width", "64", "--k", "2", "--rounds", "1"]


def test_cpu_row_has_the_jax_row_keys(capsys):
    (row,) = S.main(ARGV + ["--bs", "2"])
    assert set(row) == JAX_ROW | {"device"}
    assert row["device"] == "cpu" and row["hbm_temp"] is row["hbm_args"] is row["hbm_out"] is None
    assert (row["mode"], row["bs"], row["remat"], row["accum"], row["fine_tune"]) == ("TG", 2, False, 1, False)
    assert row["frames_per_s"] > 0 and row["ms_per_step"] == pytest.approx(1e3 * 2 / row["frames_per_s"])
    out = capsys.readouterr().out
    assert "TG 32x64 K=2" in out and "n/a" in out


def _fake_rows(monkeypatch, fail_at: int, error: Exception) -> list:
    def run_one(mode, bs, remat, *a, **kw):
        if bs == fail_at:
            raise error
        return {"mode": mode, "bs": bs, "remat": remat, "accum": 1, "fine_tune": False, "frames_per_s": 1.0,
                "ms_per_step": 1e3 * bs, "hbm_temp": None, "hbm_args": None, "hbm_out": None, "device": "cpu"}

    monkeypatch.setattr(S, "run_one", run_one)
    return S.main(ARGV + ["--bs", "2,4,8"])


def test_out_of_memory_becomes_an_error_row(monkeypatch, capsys):
    rows = _fake_rows(monkeypatch, 4, torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert [r["bs"] for r in rows] == [2, 4, 8]
    assert set(rows[1]) == JAX_ERROR_ROW and rows[1]["error"].startswith("OutOfMemoryError: CUDA out of memory")
    assert "error" not in rows[0] and "error" not in rows[2]
    assert "OutOfMemoryError" in capsys.readouterr().out


def test_other_errors_propagate(monkeypatch):
    with pytest.raises(ValueError, match="not a memory fault"):
        _fake_rows(monkeypatch, 4, ValueError("not a memory fault"))


def test_flags_are_the_jax_tools_plus_device(monkeypatch):
    import mdn_sfm_tpu.utils

    # the JAX tool turns on its persistent compilation cache before parsing
    monkeypatch.setattr(mdn_sfm_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
    want, got = defaults(jax_parser("bench_scaling")), defaults(S.build_parser())
    assert set(got) == set(want) | {"device"} and got["device"][0] == "cuda"
    assert {k for k in want if got[k] != want[k]} == set()
