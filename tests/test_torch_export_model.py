"""The port's serving export (``mdn_sfm_tpu_torch.export_model``, the
counterpart of ``tools/export_model.py``) on the CPU at 32×64, batch 1.

An f32 program exported with JAX's ``PRNGKey(0)`` parameters (carried
across with ``weights.state_dict_from_flax``) is loaded in a process that
imports torch alone, and its outputs equal the JAX tool's ``build_forward``
within the forward parity tolerance (1e-4, tests/test_torch_parity.py) and
the port's live forward within the JAX tool's round-trip tolerance (1e-6).
The CLI's bf16 program takes bf16 inputs in every convolution (read from
the nodes' metadata) and copies nothing but dtypes; a bf16 config whose
autocast is not recorded is refused. About 60 s on one worker."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu_torch import export_model as X
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_tool_flags import defaults, jax_parser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = ("flownet", "posenet", "mobile_decoder")
H, W = 32, 64
PARITY_ATOL = 1e-4  # tests/test_torch_parity.py: f32 forward against JAX
OUTPUTS = ("flow0", "mobile0", "axisangle", "translation")

# run in a fresh interpreter: load the program with torch alone, run it on
# the saved pair, and write its outputs
LOAD_AND_RUN = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
path, pair, out = sys.argv[1:4]
forward = torch.export.load(path).module()
x = np.load(pair)
with torch.no_grad():
    got = forward(torch.from_numpy(x["tgt"]), torch.from_numpy(x["ref"]))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("mdn_sfm_tpu_torch", "mdn_sfm_tpu", "jax"))
assert not loaded, loaded
np.savez(out, *[t.numpy() for t in got])
"""


def _conv_count(models) -> int:
    return sum(isinstance(m, torch.nn.Conv2d) for net in models for m in net.modules())


def test_f32_program_matches_jax_in_a_process_without_the_port(tmp_path):
    jcfg = JConfig(height=H, width=W, batch_size=1, compute_dtype="float32").validate()
    variables = jax.device_get(jax.jit(lambda k: JT.init_variables(jcfg, JT.build_models(jcfg), k))(
        jax.random.PRNGKey(0)))
    cfg = Config(height=H, width=W, batch_size=1, compute_dtype="float32").validate()
    models = T.build_models(cfg, device="cpu")
    for n, m in zip(NETS, models):
        m.load_state_dict(state_dict_from_flax(n, variables[n]))
    path = str(tmp_path / "model.pt2")
    torch.export.save(X.export_model(cfg, models, 1, "cpu"), path)

    rng = np.random.default_rng(0)
    tgt, ref = (rng.normal(size=(1, H, W, 3)).astype(np.float32) for _ in range(2))
    np.savez(tmp_path / "pair.npz", tgt=tgt, ref=ref)
    res = subprocess.run([sys.executable, "-c", LOAD_AND_RUN, path, str(tmp_path / "pair.npz"),
                          str(tmp_path / "out.npz")], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in dict(os.environ, OMP_NUM_THREADS="1").items() if k != "PYTHONPATH"})
    assert res.returncode == 0, res.stderr
    out = np.load(tmp_path / "out.npz")
    loaded = [out[f"arr_{i}"] for i in range(len(OUTPUTS))]

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        from export_model import build_forward as jax_build_forward
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    theirs = jax.device_get(jax_build_forward(jcfg, variables)(tgt, ref))
    live = X.build_forward(cfg, models)(torch.from_numpy(tgt), torch.from_numpy(ref))
    for name, got, want, ours in zip(OUTPUTS, loaded, theirs, live):
        assert got.shape == np.shape(want) == tuple(ours.shape), name
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, np.asarray(want), atol=PARITY_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got, ours.numpy(), atol=X.CHECK_ATOL, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """``python -m mdn_sfm_tpu_torch.export_model --device cpu --height 32
    --width 64 --check`` (JAX's bf16 default), in-process."""
    out = str(tmp_path_factory.mktemp("export") / "model.pt2")
    result = X.main(["--device", "cpu", "--height", str(H), "--width", str(W), "--check", "--out", out,
                     "--log_dir", str(tmp_path_factory.mktemp("no_log"))])
    return result, out


def test_cli_writes_and_round_trips(cli_artifact, capsys):
    result, out = cli_artifact
    assert result["out"] == out and os.path.getsize(out) == result["bytes"] > 0
    assert result["compute_dtype"] == "bfloat16" and result["device"] == "cpu"
    assert len(result["check"]["max_abs_err"]) == len(OUTPUTS)
    assert max(result["check"]["max_abs_err"]) <= X.CHECK_ATOL
    json.dumps(result)


def test_bf16_program_convolutions_take_bf16(cli_artifact):
    """Every convolution of the loaded program takes a bf16 input and a bf16
    weight (node metadata only), one for each Conv2d of the three nets."""
    program = torch.export.load(cli_artifact[1])
    dtypes = X.conv_input_dtypes(program)
    models = T.build_models(Config(height=H, width=W).validate(), device="cpu")
    assert len(dtypes) == _conv_count(models)
    assert set(dtypes.values()) == {(torch.bfloat16, torch.bfloat16)}


def test_bf16_program_copies_nothing_but_dtypes(cli_artifact):
    program = torch.export.load(cli_artifact[1])
    assert X.copies(program) == []
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert not any("epipolar" in t or "nms" in t or "roi_align" in t for t in targets)  # no custom op


def test_unrecorded_autocast_is_refused(monkeypatch):
    """A bf16 config whose export holds float32 convolutions (here: autocast
    switched off in the forward) raises instead of writing the program."""
    import contextlib

    cfg = Config(height=H, width=W, batch_size=1, compute_dtype="bfloat16").validate()
    models = T.build_models(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(T, "_autocast", lambda cfg, device: contextlib.nullcontext())
    with pytest.raises(RuntimeError, match="did not record the bf16 autocast"):
        X.export_model(cfg, models, 1, "cpu")


def test_flags_are_the_jax_tools_with_device_for_platforms():
    want, got = defaults(jax_parser("export_model")), defaults(X.build_parser())
    assert set(got) == set(want) - {"platforms"} | {"device"} and got["device"][0] == "cuda"
    assert {k for k in got if k != "device" and got[k] != want[k]} == {"out"}
    assert want["out"][0] == "model.shlo" and got["out"][0] == "model.pt2"
