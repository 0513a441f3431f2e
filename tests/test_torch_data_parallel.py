"""The data-parallel step of the port on the CPU: two gloo ranks, each a
process of its own, take the step through ``torch.distributed``.

Held against JAX (same initial variables through ``weights.state_dict_from_flax``,
same synthetic global batch, float32, ``disable_augment``, TG):

* two ranks of 2 samples against JAX's single-device step on the global
  batch of 4: losses, ``grad_norm`` and the decoder's params after Adam, at
  ``tests/test_torch_train_step.py``'s bounds, with the clip active at the
  default ``clip_grad=1.0``. ``grad_norm`` is the norm of the averaged
  gradient, with no factor of the group's size;
* the same with ``accum_steps=2``;
* with ``bn_frozen_eval=False``, flow's and pose's BatchNorm running
  averages after step 0 against JAX's ``shard_map`` step on a 2-device mesh
  of the suite's virtual CPU devices (its params are not compared: the JAX
  mesh step reports and clips at ``grad_norm`` × its device count).

And within the port: every rank's params bitwise equal after every case;
with augmentation, two ranks against one process on the global batch (each
sample's draw is the one-process step's); K = 2 steps a dispatch through the
group bitwise equal to two single group steps.

Run as a script, this file is one rank's worker.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.config import Config, Mode
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 4, 32, 64   # the global batch: 2 samples a rank
WORLD = 2
STEPS = 2
STEPS_PER_EPOCH = 10
NETS = ("flownet", "posenet", "mobile_decoder")
KW = dict(height=H, width=W, batch_size=B, threshold=9.22, w_d2_sim=0.0, compute_dtype="float32")
# the cases against JAX: config options and steps
JAX_CASES = {"plain": (dict(), STEPS), "accum2": (dict(accum_steps=2), STEPS),
             "bn_train": (dict(bn_frozen_eval=False), 1)}
K = 2  # steps a dispatch in the augmented case
WORKER_TIMEOUT_S = 600


def _config(**kw) -> Config:
    return Config(mode=Mode.TG, **{**KW, **kw}).validate()


def _snapshot(models) -> dict:
    return {n: {k: v.detach().clone() for k, v in m.state_dict().items()} for n, m in zip(NETS, models)}


# ------------------------------------------------------------------ worker


def _worker(rank: int, world: int, work: str) -> None:
    """One rank: every case through the group, its results to out_{rank}.pt."""
    import torch.distributed as dist

    from mdn_sfm_tpu_torch.parallel import init_distributed, local_rows, shutdown_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", world, rank, f"file://{os.path.join(work, 'store')}")
    group = dist.group.WORLD
    inp = torch.load(os.path.join(work, "inputs.pt"))
    out = {}
    try:
        for name, (kw, steps) in JAX_CASES.items():
            cfg = _config(disable_augment=True, **kw)
            models = TT.build_models(cfg, device="cpu")
            for net, m in zip(NETS, models):
                m.load_state_dict(inp["state"][net], strict=True)
            opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
            batch = {k: local_rows(v, rank, world) for k, v in inp["batch"].items()}
            metrics = [{k: float(v) for k, v in TT.train_step(cfg, models, opt, batch, group=group)[0].items()}
                       for _ in range(steps)]
            out[name] = {"metrics": metrics, "state": _snapshot(models)}

        # augmentation on, the nets from the config's seed on every rank:
        # K single group steps, then one K-step dispatch from the same start
        cfg = _config()
        batches = {k: local_rows(v.transpose(0, 1), rank, world).transpose(0, 1) for k, v in inp["kbatches"].items()}
        models = TT.build_models(cfg, device="cpu")
        out["init"] = _snapshot(models)
        opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
        singles = [TT.train_step(cfg, models, opt, {k: v[j] for k, v in batches.items()}, group=group,
                                 generator=TT.step_generator(cfg.seed, j, "cpu"))[0] for j in range(K)]
        out["singles"] = {"metrics": [{k: float(v) for k, v in m.items()} for m in singles],
                          "state": _snapshot(models)}
        models = TT.build_models(cfg, device="cpu")
        opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
        kstep = TT.make_multi_train_step(cfg, models, opt, K, group=group)
        kstep(batches, TT.multi_step_draws(cfg, batches, 0, group))
        out["dispatch"] = {"metrics": [{k: float(v[j]) for k, v in kstep.step_metrics.items()} for j in range(K)],
                           "state": _snapshot(models)}
        torch.save(out, os.path.join(work, f"out_{rank}.pt"))
    finally:
        shutdown_distributed()


# -------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def jax_side():
    """JAX's steps on the global batch from one init: the single-device step
    (plain, accum_steps=2) and the shard_map step on a 2-device mesh
    (train-mode BN); the init converted to the port's state dicts."""
    import jax

    from mdn_sfm_tpu import training as JT
    from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode
    from mdn_sfm_tpu.data.synthetic import synthetic_batch
    from mdn_sfm_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from mdn_sfm_tpu_torch.weights import state_dict_from_flax

    colors, K_ = synthetic_batch(B, H, W, seed=0)
    batch = {"colors_u8": colors, "K": K_}
    out = {"batch": batch}
    for name, (kw, steps) in JAX_CASES.items():
        jcfg = JConfig(mode=JMode.TG, donate_state=False, disable_augment=True, **KW, **kw).validate()
        models = JT.build_models(jcfg)
        variables = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
        out.setdefault("state", {n: state_dict_from_flax(n, variables[n]) for n in NETS})
        tx = JT.make_optimizer(jcfg, STEPS_PER_EPOCH)
        state, frozen = JT.create_train_state(jcfg, models, variables, tx)
        mesh = make_mesh(WORLD) if name == "bn_train" else None
        step = JT.make_train_step(jcfg, models, tx, mesh=mesh)
        jbatch = batch
        if mesh is not None:
            state, frozen, jbatch = replicate(mesh, state), replicate(mesh, frozen), shard_batch(mesh, batch)
        metrics = []
        for _ in range(steps):
            state, frozen, m, _ = step(state, frozen, jbatch, jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        frozen = jax.device_get(frozen)
        out[name] = {"metrics": metrics,
                     "mobile": state_dict_from_flax("mobile_decoder",
                                                    {"params": jax.device_get(state.params["mobile_decoder"])}),
                     "stats": {n: state_dict_from_flax(n, frozen[n]) for n in ("flownet", "posenet")}}
    return out


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """The two ranks' results, each rank a process of its own."""
    from mdn_sfm_tpu_torch.data.synthetic import synthetic_batch

    work = str(tmp_path_factory.mktemp("dp"))
    pairs = [synthetic_batch(B, H, W, seed=s) for s in range(1, K + 1)]
    torch.save({"state": jax_side["state"],
                "batch": {k: torch.from_numpy(v) for k, v in jax_side["batch"].items()},
                "kbatches": {"colors_u8": torch.from_numpy(np.stack([c for c, _ in pairs])),
                             "K": torch.from_numpy(np.stack([q for _, q in pairs]))}},
               os.path.join(work, "inputs.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(WORLD),
                               "--work", work], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return [torch.load(os.path.join(work, f"out_{r}.pt")) for r in range(WORLD)], pairs


def _params_close(got: dict, want: dict, steps: int) -> None:
    """The post-Adam params rule of tests/test_torch_train_step.py."""
    from test_torch_train_step import LR, NOISE_FLOOR_SHARE, PARAM_ATOL

    assert set(got) == set(want)
    diff = np.concatenate([np.abs(got[k].numpy() - np.asarray(want[k])).ravel() for k in want])
    assert diff.max() <= 2 * LR * steps, diff.max()
    assert (diff > PARAM_ATOL).mean() <= NOISE_FLOOR_SHARE, (diff > PARAM_ATOL).mean()


@pytest.mark.parametrize("case", ["plain", "accum2"])
def test_two_ranks_match_jax_single_device(jax_side, ranks, case):
    """Losses and grad_norm at each step, the decoder's params after them."""
    from test_torch_train_step import LOSS_RTOL

    outs, _ = ranks
    want = jax_side[case]["metrics"]
    got = outs[0][case]["metrics"]
    assert want[0]["grad_norm"] > Config().clip_grad  # the clip is active
    for step in range(STEPS):
        assert set(got[step]) == set(want[step])
        for k in want[step]:
            assert np.isfinite(got[step][k]), k
            np.testing.assert_allclose(got[step][k], want[step][k], rtol=LOSS_RTOL[step], err_msg=f"{case} {k}")
    _params_close(outs[0][case]["state"]["mobile_decoder"], jax_side[case]["mobile"], STEPS)


@pytest.mark.parametrize("case", list(JAX_CASES) + ["singles", "dispatch"])
def test_params_bitwise_equal_across_ranks(ranks, case):
    """Every rank's three nets (params and BN averages) after the case, and
    its metrics, equal bit for bit."""
    outs, _ = ranks
    a, b = outs[0][case], outs[1][case]
    assert a["metrics"] == b["metrics"]
    for net in NETS:
        for k, v in a["state"][net].items():
            assert torch.equal(v, b["state"][net][k]), (net, k)


def test_bn_statistics_match_jax_mesh_step(jax_side, ranks):
    """bn_frozen_eval=False: flow's and pose's running averages after step 0,
    the mean over the ranks of each rank's update, against the JAX mesh
    step's pmean of batch_stats (f32, per element: 1e-5 relative + 1e-6)."""
    outs, _ = ranks
    want = jax_side["bn_train"]["stats"]
    got = outs[0]["bn_train"]["state"]
    n = 0
    for net in ("flownet", "posenet"):
        for k, v in want[net].items():
            if k.endswith(("running_mean", "running_var")):
                assert not torch.equal(got[net][k], jax_side["state"][net][k]), (net, k)  # they moved
                np.testing.assert_allclose(got[net][k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-6,
                                           err_msg=f"{net} {k}")
                n += 1
    assert n > 0


def test_two_ranks_draw_the_global_batch_augmentation(ranks):
    """With augmentation, two ranks take K steps as one process on the
    global batch does (each sample's flip and zoom-crop from the same
    step_generator draw): the metrics at tests/test_torch_train_step.py's
    bounds, the decoder's params by its rule."""
    from test_torch_train_step import LOSS_RTOL

    outs, pairs = ranks
    cfg = _config()
    models = TT.build_models(cfg, device="cpu")
    for net, m in zip(NETS, models):
        assert all(torch.equal(v, outs[0]["init"][net][k]) for k, v in m.state_dict().items())
    opt = TT.make_optimizer(cfg, models, STEPS_PER_EPOCH)
    want = []
    for j, (colors, K_) in enumerate(pairs):
        batch = {"colors_u8": torch.from_numpy(colors), "K": torch.from_numpy(K_)}
        m, _ = TT.train_step(cfg, models, opt, batch, generator=TT.step_generator(cfg.seed, j, "cpu"))
        want.append({k: float(v) for k, v in m.items()})
    got = outs[0]["singles"]["metrics"]
    for step in range(K):
        for k in want[step]:
            np.testing.assert_allclose(got[step][k], want[step][k], rtol=LOSS_RTOL[step], err_msg=k)
    _params_close(outs[0]["singles"]["state"]["mobile_decoder"],
                  {k: v.numpy() for k, v in models.mobile.state_dict().items()}, K)


def test_k_step_dispatch_equals_single_group_steps(ranks):
    """K = 2 steps a dispatch through the group (on the CPU the K steps in
    turn, each with its all-reduce) equal two single group steps bit for bit."""
    outs, _ = ranks
    for r in range(WORLD):
        d, s = outs[r]["dispatch"], outs[r]["singles"]
        assert d["metrics"] == s["metrics"]
        for net in NETS:
            assert all(torch.equal(v, s["state"][net][k]) for k, v in d["state"][net].items()), net


def test_all_reduce_mean_on_one_rank_is_the_identity(tmp_path):
    """A one-rank group's mean leaves each tensor as it was, bit for bit,
    in shape and dtype, through one flat buffer."""
    import torch.distributed as dist

    from mdn_sfm_tpu_torch.parallel import all_reduce_mean, init_distributed, shutdown_distributed

    init_distributed("cpu", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        g = torch.Generator().manual_seed(0)
        xs = [torch.randn(3, 5, generator=g), torch.randn((), generator=g), torch.randn(7, generator=g)]
        ys = all_reduce_mean(xs, dist.group.WORLD)
        assert all(torch.equal(x, y) and x.shape == y.shape and x.dtype == y.dtype for x, y in zip(xs, ys))
    finally:
        shutdown_distributed()


def test_local_rows_splits_the_leading_axis():
    from mdn_sfm_tpu_torch.parallel import local_rows

    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(torch.cat([local_rows(x, r, 3) for r in range(3)]), x)
    with pytest.raises(ValueError, match="equal shards"):
        local_rows(x, 0, 4)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--work", required=True)
    a = ap.parse_args()
    _worker(a.rank, a.world, a.work)
