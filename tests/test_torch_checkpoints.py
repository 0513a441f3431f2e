"""Checkpoints across the two packages: JAX variables exported with
``export_pth`` load into the port and equal ``state_dict_from_flax``; the
port's checkpoint loads back through the JAX ``load_checkpoint`` (its
``.pth`` route) and equals it; partial loads keep unmatched keys; an
interrupted save never counts for ``--resume auto``; Adam's state round-trips,
loads into ``torch.optim.Adam``, and optax's state carries across. Weights
are copied, so equality is exact unless a test states a tolerance."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import checkpoints as JC
from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig
from mdn_sfm_tpu_torch import checkpoints as C
from mdn_sfm_tpu_torch import training as T
from mdn_sfm_tpu_torch.config import Config
from mdn_sfm_tpu_torch.weights import adam_state_from_optax, state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NETS = ("flownet", "posenet", "mobile_decoder")
KW = dict(height=32, width=64, compute_dtype="float32")


@pytest.fixture(scope="module")
def variables():
    cfg = JConfig(**KW).validate()
    models = JT.build_models(cfg)
    # jitted: the same values as the eager init, in a third of the time
    return jax.device_get(jax.jit(lambda k: JT.init_variables(cfg, models, k))(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def models():
    return T.build_models(Config(**KW).validate(), torch.Generator().manual_seed(1), "cpu")


def _modules(models):
    return dict(zip(NETS, models))


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_jax_export_loads_into_port(tmp_path, variables, models):
    folder = C.weights_folder(str(tmp_path), "v0", 0)
    os.makedirs(folder)
    for n in NETS:
        JC.export_pth(os.path.join(folder, f"{n}.pth"), n, variables[n])
    mods = _modules(models)
    merged, adam, step = C.load_checkpoint(folder, {n: m.state_dict() for n, m in mods.items()})
    assert adam is None and step == 0
    for n in NETS:
        mods[n].load_state_dict(merged[n], strict=True)
        _equal(mods[n].state_dict(), state_dict_from_flax(n, variables[n]))


def test_port_checkpoint_loads_back_through_jax(tmp_path, variables, models):
    mods = _modules(models)
    folder = C.weights_folder(str(tmp_path), "v", 3)
    C.save_checkpoint(folder, {n: C.to_host(m.state_dict()) for n, m in mods.items()}, step=12, base_step=4)
    assert C.read_meta(folder) == {"step": 12, "base_step": 4}
    zeroed = jax.tree.map(np.zeros_like, variables)
    loaded, _, step = JC.load_checkpoint(folder, zeroed)
    assert step == 12
    for n in NETS:
        # JAX holds only what its nets have; the port's state dict says the same
        _equal(state_dict_from_flax(n, loaded[n]), {k: v for k, v in mods[n].state_dict().items()})


def test_eval_forward_matches_jax(variables):
    """``training.eval_forward`` against ``make_eval_forward`` on the same
    weights and normalized pair, f32: the forward tolerance of
    tests/test_torch_parity.py (1e-4)."""
    cfg = Config(**KW).validate()
    nets = T.build_models(cfg, device="cpu")
    for n, m in zip(NETS, nets):
        m.load_state_dict(state_dict_from_flax(n, variables[n]))
    jcfg = JConfig(**KW).validate()
    fwd = JT.make_eval_forward(jcfg, JT.build_models(jcfg))
    rng = np.random.default_rng(0)
    tgt, ref = (rng.normal(size=(2, 32, 64, 3)).astype(np.float32) for _ in range(2))
    ours = T.eval_forward(cfg, nets, torch.from_numpy(tgt), torch.from_numpy(ref))
    theirs = jax.device_get(fwd(variables, tgt, ref))
    for s in cfg.scales:
        for o, t in ((ours[0], theirs[0]), (ours[1], theirs[1])):
            assert not o[s].requires_grad
            np.testing.assert_allclose(o[s].numpy(), np.asarray(t[s]), atol=1e-4, err_msg=str(s))
    for o, t in zip(ours[2:], theirs[2:]):
        np.testing.assert_allclose(o.reshape(t.shape).numpy(), np.asarray(t), atol=1e-4)


def test_partial_load_keeps_unmatched_keys(tmp_path, models):
    target = {"a": torch.zeros(3), "b": torch.zeros(2), "c": torch.zeros(1)}
    loaded = {"a": torch.ones(3), "b": torch.ones(5), "extra": torch.ones(1)}
    merged = C.merge_partial(target, loaded)
    assert set(merged) == set(target)
    assert torch.equal(merged["a"], torch.ones(3))
    assert torch.equal(merged["b"], torch.zeros(2))  # shape mismatch: kept
    assert torch.equal(merged["c"], torch.zeros(1))  # missing: kept

    # through a file: a mobile decoder missing one head keeps its own head
    mob = models.mobile.state_dict()
    folder = str(tmp_path / "w")
    drop = "mobile_net.13.conv.weight"
    C.save_checkpoint(folder, {"mobile_decoder": {k: v + 1 for k, v in mob.items() if k != drop}})
    got, _, _ = C.load_checkpoint(folder, {"mobile_decoder": mob}, ("mobile_decoder",))
    for k, v in mob.items():
        assert torch.equal(got["mobile_decoder"][k], v if k == drop else v + 1), k


def test_latest_weights_idx_skips_an_interrupted_save(tmp_path, models):
    d = str(tmp_path)
    sd = {"mobile_decoder": C.to_host(models.mobile.state_dict())}
    assert C.latest_weights_idx(d, "v") is None
    C.save_checkpoint(C.weights_folder(d, "v", 4), sd, step=40)
    # a save cut short: the model file is there, meta.json is not, the
    # in-progress marker is
    half = C.weights_folder(d, "v", 5)
    os.makedirs(half)
    open(os.path.join(half, C.IN_PROGRESS), "w").close()
    open(os.path.join(half, "mobile_decoder.pth"), "wb").write(b"\x00trunc")
    assert C.latest_weights_idx(d, "v") == 4
    # a folder without meta.json, marker or model is no checkpoint either
    os.makedirs(C.weights_folder(d, "v", 7))
    assert C.latest_weights_idx(d, "v") == 4
    # a reference folder has no meta.json and no marker, and counts
    ref = C.weights_folder(d, "v", 6)
    os.makedirs(ref)
    torch.save(sd["mobile_decoder"], os.path.join(ref, "mobile_decoder.pth"))
    assert C.latest_weights_idx(d, "v") == 6
    assert C.read_meta(ref) == {}


def test_save_is_atomic_and_overwrite_recommits(tmp_path, models):
    folder = str(tmp_path / "w")
    sd = {"mobile_decoder": C.to_host(models.mobile.state_dict())}
    for step in (1, 2):
        C.save_checkpoint(folder, sd, step=step)
        names = os.listdir(folder)
        assert not [f for f in names if f.endswith(".tmp")] and C.IN_PROGRESS not in names
        with open(os.path.join(folder, "meta.json")) as f:
            assert json.load(f)["step"] == step


def test_msgpack_only_folder_says_how_to_convert(tmp_path, variables):
    folder = str(tmp_path / "w")
    JC.save_checkpoint(folder, variables, models_to_save=("mobile_decoder",))
    with pytest.raises(FileNotFoundError, match="export_pth"):
        C.load_checkpoint(folder, {"mobile_decoder": {}}, ("mobile_decoder",))
    with pytest.raises(FileNotFoundError, match="no checkpoint for posenet"):
        C.load_checkpoint(folder, {"posenet": {}}, ("posenet",))


def _stepped_adam(models, steps=3):
    cfg = Config(**KW).validate()
    opt = T.make_optimizer(cfg, models, 10)
    rng = torch.Generator().manual_seed(0)
    for _ in range(steps):
        opt.step([torch.randn(p.shape, generator=rng) for p in opt.params])
    return cfg, opt


def test_adam_state_round_trips(tmp_path, models):
    cfg, opt = _stepped_adam(models)
    folder = str(tmp_path / "w")
    C.save_checkpoint(folder, {"mobile_decoder": C.to_host(models.mobile.state_dict())},
                      C.to_host(opt.state_dict()), step=3)
    _, adam, step = C.load_checkpoint(folder, {}, (), load_adam=True)
    fresh = T.make_optimizer(cfg, models, 10)
    fresh.load_state_dict(adam)
    assert step == 3 and fresh.count == opt.count == 3
    assert fresh.lr(fresh.count) == opt.lr(opt.count)
    for a, b in zip(fresh.mu + fresh.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
    # torch.optim.Adam reads the same file: the reference repo can load it
    ref = torch.optim.Adam(list(models.mobile.parameters()), lr=cfg.learning_rate)
    ref.load_state_dict(adam)
    for i, (mu, nu) in enumerate(zip(opt.mu, opt.nu)):
        s = ref.state[ref.param_groups[0]["params"][i]]
        assert float(s["step"]) == 3 and torch.equal(s["exp_avg"], mu) and torch.equal(s["exp_avg_sq"], nu)
    # a torch.optim.Adam that never stepped saves an empty state: a fresh Adam
    fresh.load_state_dict(torch.optim.Adam(list(models.mobile.parameters())).state_dict())
    assert fresh.count == 0 and all(float(t.abs().max()) == 0 for t in fresh.mu)


def test_adam_refuses_another_parameter_set(models):
    _, opt = _stepped_adam(models, 1)
    other = T.Adam(opt.params[:-1], lambda k: 1e-4, 0.9, 0.999, 1.0)
    with pytest.raises(ValueError, match="parameters"):
        other.load_state_dict(opt.state_dict())


def test_adam_state_from_optax_maps_moments(variables, models):
    """optax's (count, mu, nu) on the Flax tree → the port's names and
    layout, with conv kernels transposed as their params are."""
    import optax

    params = {"mobile_decoder": variables["mobile_decoder"]["params"]}
    tx = JT.make_optimizer(JConfig(**KW).validate(), 10)
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    names = [n for n, _ in models.mobile.named_parameters()]
    sd = adam_state_from_optax(jax.device_get(state), names)
    adam = next(s for s in jax.tree.leaves(state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    mu = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(adam.mu["mobile_decoder"])})
    nu = state_dict_from_flax("mobile_decoder", {"params": jax.device_get(adam.nu["mobile_decoder"])})
    for i, n in enumerate(names):
        assert float(sd["state"][i]["step"]) == 2
        assert torch.equal(sd["state"][i]["exp_avg"], mu[n]) and torch.equal(sd["state"][i]["exp_avg_sq"], nu[n])
    opt = T.make_optimizer(Config(**KW).validate(), models, 10)
    opt.load_state_dict(sd)
    assert opt.count == 2
    with pytest.raises(KeyError):
        adam_state_from_optax(jax.device_get(state), names[:-1])
