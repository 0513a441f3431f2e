"""The port's four bench tools (``bench_e2e``, ``bench_eval``,
``bench_loader``, ``bench_precompute``) on the CPU at tiny sizes: each one's
output keys and the work it counted (steps and epochs, the trimmed n, the
batches), and the flags of each tool and of ``quantify_d2_scale`` against
the JAX tool's (``tools/*.py``, read by path): the same defaults, plus
``--device``, and no TPU figure (``bench_e2e --compute_fps`` is the card's).
The tools' numbers here are CPU times and stand for nothing on the card.
About 30 s on one worker."""

import json
import os

import pytest

from mdn_sfm_tpu_torch import bench_e2e, bench_eval, bench_loader, bench_precompute, quantify_d2_scale
from mdn_sfm_tpu_torch.data.splits import repo_root
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tool_flags import defaults, jax_parser

# the JAX bench_e2e's result keys, and the device the port's result names
E2E_KEYS = {"metric", "value", "unit", "loader_only_triplets_per_s", "compute_only_frames_per_s",
            "implied_host_cores_to_feed_chip", "host_cores", "steps", "epochs", "window_s", "shape", "workers",
            "cache", "device"}
TPU_COMPUTE_FPS = 262.0  # the JAX tool's default: a TPU figure


@pytest.mark.parametrize("tool", ["bench_e2e", "bench_eval", "bench_precompute", "quantify_d2_scale"])
def test_flags_are_the_jax_tools_plus_device_and_no_tpu_figure(tool):
    port = {"bench_e2e": bench_e2e, "bench_eval": bench_eval, "bench_precompute": bench_precompute,
            "quantify_d2_scale": quantify_d2_scale}[tool]
    want, got = defaults(jax_parser(tool)), defaults(port.build_parser())
    assert set(got) == set(want) | {"device"} and got["device"][0] == "cuda"
    differ = {k for k in want if got[k] != want[k]}
    if tool == "bench_e2e":
        assert differ == {"compute_fps"} and want["compute_fps"][0] == TPU_COMPUTE_FPS
        assert got["compute_fps"][0] == bench_e2e.H100_TG_K16_FPS == 197.8
        assert "H100" in bench_e2e.build_parser().format_help()
    else:
        assert not differ


def test_bench_e2e_counts_whole_epochs_of_steps(monkeypatch, capsys):
    """6 items of batch 2 at K = 2: an epoch is one dispatch and one tail
    step, so the timed steps are epochs × 3; the split is gone afterwards.
    The Trainer's TensorBoard writers are left out (their import alone takes
    15 s here)."""
    from mdn_sfm_tpu_torch import trainer

    monkeypatch.setattr(trainer.Trainer, "_make_writers", lambda self: None)
    n_items, batch = 6, 2
    res = bench_e2e.main(["--device", "cpu", "--n_items", str(n_items), "--batch_size", str(batch),
                          "--steps_per_dispatch", "2", "--height", "32", "--width", "64", "--window", "0",
                          "--workers", "1"])
    assert set(res) == E2E_KEYS and res["device"] == "cpu"
    assert res["epochs"] >= 1 and res["steps"] == res["epochs"] * (n_items // batch)
    assert res["compute_only_frames_per_s"] == 197.8 and res["value"] > 0 and res["loader_only_triplets_per_s"] > 0
    assert res["shape"] == "32x64 bs2 TG K=2"
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert not os.path.exists(os.path.join(repo_root(), "splits", bench_e2e.SPLIT_NAME))


def test_bench_eval_runs_two_evaluations(capsys):
    res = bench_eval.main(["--device", "cpu", "--n", "3", "--height", "32", "--width", "96",
                           "--eval_batch_size", "2"])
    assert set(res) == {"n", "eval_batch_size", "seconds", "samples_per_s", "device"}
    assert res["n"] == 3 and res["eval_batch_size"] == 2 and res["device"] == "cpu" and res["samples_per_s"] > 0
    out = capsys.readouterr().out
    assert out.count("-> Done!") == 2 and "3 samples in" in out


def test_bench_precompute_trims_to_a_batch_multiple():
    from mdn_sfm_tpu_torch.masks.maskrcnn import MaskRCNNBackend

    backend = MaskRCNNBackend(max_det=4, fast=True, input_hw=(64, 128), device="cpu")
    calls = {"predict": 0, "union": []}
    real_predict, real_union = backend.predict, backend.predict_union_batch

    def predict(img):
        calls["predict"] += 1
        return real_predict(img)

    def union(imgs):
        calls["union"].append(len(imgs))
        return real_union(imgs)

    backend.predict, backend.predict_union_batch = predict, union
    res = bench_precompute.bench(backend, n=5, batch=2, scene_hw=(48, 96))
    assert set(res) == {"n", "batch", "predict_s_per_img", "union_batch_s_per_img", "speedup"}
    assert res["n"] == 4 and res["batch"] == 2
    assert calls == {"predict": 1 + 4, "union": [2, 2, 2]}  # one warm-up call of each, then the timed ones


def test_bench_precompute_refuses_fewer_frames_than_a_batch(monkeypatch):
    """``--n 4 --batch 8`` leaves no whole batch to time: a ValueError naming
    both values, not a trim to zero frames."""
    from mdn_sfm_tpu_torch.masks import maskrcnn

    monkeypatch.setattr(maskrcnn, "MaskRCNNBackend", lambda **kw: object())
    with pytest.raises(ValueError, match=r"n=4 is less than batch=8"):
        bench_precompute.main(["--n", "4", "--batch", "8", "--device", "cpu"])


def test_bench_loader_times_both_decoders(capsys):
    from mdn_sfm_tpu_torch import native

    if not native.imgio_available():  # the JAX tool's early return
        assert bench_loader.main(["4"]) == {}
        return
    res = bench_loader.main(["4", "32", "64"])
    assert set(res) == {"PIL+cv2", "native C++"}
    for r in res.values():
        assert r["batches"] == 1 and r["ms_per_triplet"] > 0 and r["loader_triplets_per_s"] > 0
    out = capsys.readouterr().out
    assert "4 triplets of 375×1242 PNG → 32×64" in out and out.count("HostLoader(4 workers)") == 2


def test_bench_loader_returns_early_without_native_imgio(monkeypatch, capsys):
    from mdn_sfm_tpu_torch import native

    monkeypatch.setattr(native, "imgio_available", lambda: False)
    assert bench_loader.main(["4"]) == {}
    assert "nothing to compare" in capsys.readouterr().out
