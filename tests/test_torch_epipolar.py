"""The port's |epipolar residual| map: its plain version against the Pallas
kernel (interpret mode, as tests/test_pallas_ops.py runs it on the CPU) and
against ``geometry.epipolar_residual`` where the Pallas kernel cannot go
(H % 8 ≠ 0); and the CPU dispatch of the wrapper. The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdn_sfm_tpu.geometry import epipolar_residual, rot_from_axisangle
from mdn_sfm_tpu.ops.pallas_epipolar import epipolar_abs_residual_pallas
from mdn_sfm_tpu_torch.ops import epipolar as te
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# same formulas in f32 on both sides (the bound tests/test_pallas_ops.py uses
# for the Pallas kernel against its jnp path)
ATOL = RTOL = 1e-4


def _inputs(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    flow = (rng.normal(size=(b, h, w, 2)) * 2).astype(np.float32)
    K = np.array([[0.6 * w, 0, w / 2], [0, 1.9 * h, h / 2], [0, 0, 1]], np.float32)
    inv_K = np.broadcast_to(np.linalg.inv(K), (b, 3, 3)).astype(np.float32)
    aa = (rng.normal(size=(b, 3)) * 0.05).astype(np.float32)
    R = np.array(rot_from_axisangle(jnp.asarray(aa)))
    t = (rng.normal(size=(b, 3)) * 0.1).astype(np.float32)
    return flow, inv_K, R, t


@pytest.mark.parametrize("shape", [(2, 16, 128), (1, 24, 80)])
def test_plain_matches_pallas_interpret(shape):
    args = _inputs(*shape)
    want = epipolar_abs_residual_pallas(*map(jnp.asarray, args), interpret=True)
    got = te.epipolar_abs_residual(*map(torch.from_numpy, args))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(2, 37, 83), (1, 1, 5)])
def test_plain_matches_jnp_ragged(shape):
    args = _inputs(*shape, seed=1)
    want = jnp.abs(epipolar_residual(*map(jnp.asarray, args)))
    got = te.epipolar_abs_residual_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_permuted_view_input():
    """A (B, H, W, 2) permuted view of NCHW flow gives the same map as the
    contiguous tensor (the kernel reads views through their strides)."""
    flow, inv_K, R, t = map(torch.from_numpy, _inputs(2, 24, 40, seed=2))
    view = flow.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    torch.testing.assert_close(
        te.epipolar_abs_residual(view, inv_K, R, t), te.epipolar_abs_residual(flow, inv_K, R, t),
        atol=0, rtol=0,
    )


def test_cpu_dispatch_builds_nothing_and_counts_nothing():
    """On a machine without nvcc, importing the op and running it on CPU
    tensors builds no kernel, loads no library and leaves the counters at 0."""
    code = (
        "import torch\n"
        "from mdn_sfm_tpu_torch.ops import epipolar as te, _build\n"
        "built = sorted(_build.BUILD_DIR.glob('*')) if _build.BUILD_DIR.exists() else []\n"
        "b, h, w = 2, 8, 16\n"
        "flow = torch.randn(b, h, w, 2)\n"
        "inv_K = torch.eye(3).expand(b, 3, 3)\n"
        "R = torch.eye(3).expand(b, 3, 3)\n"
        "t = torch.tensor([[1.0, 0.5, 0.25]]).expand(b, 3)\n"
        "out = te.epipolar_abs_residual(flow, inv_K, R, t)\n"
        "assert out.shape == (b, h, w)\n"
        "assert te.epipolar_abs_residual_maps.launches == te.epipolar_abs_residual_maps.maps == 0\n"
        "assert _build.loaded() == []\n"
        "assert built == (sorted(_build.BUILD_DIR.glob('*')) if _build.BUILD_DIR.exists() else [])\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_wrapper_refuses_other_devices():
    flow, inv_K, R, t = (torch.from_numpy(x).to("meta") for x in _inputs(1, 8, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        te.epipolar_abs_residual(flow, inv_K, R, t)
