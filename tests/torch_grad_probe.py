"""How far the DS train step's gradient norm lies from float64, in each
package, on the CPU (the measurement behind the ``grad_norm`` bound of
``tests/test_torch_ds_dc_step.py`` and behind ``training._native_cpu_convs``):

    JAX_PLATFORMS=cpu python tests/torch_grad_probe.py

Prints one JSON line:

* ``conv_weight_grad_rel_err``: one 3×3 conv's weight gradient over 4×64×96
  positions, in float32 through oneDNN and through PyTorch's own convolution,
  against float64;
* ``grad_norm``: the DS step's ``grad_norm`` at step 0 on the test's inputs —
  the port in float64 (the reference), the port in float32 with its own
  convolutions (what ``train_step`` runs on the CPU) and with oneDNN's, the JAX
  step's float32 gradients summed in float64, and the norm the JAX step itself
  reports — with each one's relative distance from the float64 norm.
"""

import json
import os
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]
import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests run it)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import test_torch_ds_dc_step as ds  # noqa: E402
from mdn_sfm_tpu import training as JT  # noqa: E402
from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode  # noqa: E402
from mdn_sfm_tpu.data.synthetic import synthetic_batch  # noqa: E402
from mdn_sfm_tpu.masks.providers import PrecomputedMaskProvider as JPrecomputed  # noqa: E402
from mdn_sfm_tpu_torch import training as TT  # noqa: E402
from mdn_sfm_tpu_torch.config import Config, Mode  # noqa: E402
from mdn_sfm_tpu_torch.data.augment import augment_batch  # noqa: E402
from mdn_sfm_tpu_torch.weights import state_dict_from_flax  # noqa: E402


def conv_errors() -> dict:
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 66, 98, generator=g)
    w = torch.randn(16, 16, 3, 3, generator=g) * 0.1
    up = torch.randn(4, 16, 64, 96, generator=g)

    def weight_grad(dtype, onednn):
        was = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = onednn
        try:
            ww = w.to(dtype).requires_grad_()
            (gw,) = torch.autograd.grad((F.conv2d(x.to(dtype), ww) * up.to(dtype)).sum(), [ww])
        finally:
            torch.backends.mkldnn.enabled = was
        return gw.double()

    ref = weight_grad(torch.float64, False)
    return {name: float((weight_grad(torch.float32, onednn) - ref).norm() / ref.norm())
            for name, onednn in (("onednn", True), ("native", False))}


def ds_norms() -> dict:
    mask_dir = tempfile.mkdtemp()
    ds._write_masks(mask_dir)
    kw = dict(height=ds.H, width=ds.W, batch_size=ds.B, threshold=9.22, w_d2_sim=0.05, compute_dtype="float32",
              disable_augment=True, mask_provider="precomputed", mask_dir=mask_dir, ds_similarity_term=True)
    colors, K = synthetic_batch(ds.B, ds.H, ds.W, seed=0)
    masks = JPrecomputed(mask_dir).union_masks(ds.KEYS, ds.H, ds.W)

    jcfg = JConfig(mode=JMode.DS, donate_state=False, **kw).validate()
    models = JT.build_models(jcfg)
    variables = jax.device_get(JT.init_variables(jcfg, models, jax.random.PRNGKey(0)))
    tx = JT.make_optimizer(jcfg, ds.STEPS_PER_EPOCH)
    state, frozen = JT.create_train_state(jcfg, models, variables, tx)
    jbatch = {"colors_u8": jnp.asarray(colors), "K": jnp.asarray(K), "instance_mask": jnp.asarray(masks)}
    rng = jax.random.PRNGKey(1)
    step_rng = jax.random.fold_in(rng, state.step)
    grads, _ = jax.jit(lambda p: JT._microbatch_grads(jcfg, models, None, p, frozen, jbatch, step_rng, 0))(
        state.params)
    jax_grads_f64 = float(np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum() for g in jax.tree.leaves(grads))))
    _, _, metrics, _ = JT.make_train_step(jcfg, models, tx)(state, frozen, jbatch, rng)

    cfg = Config(mode=Mode.DS, **kw).validate()

    def port(dtype, onednn):
        nets = TT.build_models(cfg, device="cpu")
        for net, module in zip(("flownet", "posenet", "mobile_decoder"), nets):
            module.load_state_dict(state_dict_from_flax(net, variables[net]), strict=True)
        float_ = torch.Tensor.float
        if dtype == torch.float64:  # the losses' casts to float32 become casts to float64
            for m in nets:
                m.double()
            torch.Tensor.float = lambda t, *a, **k: t.double() if t.is_floating_point() else float_(t, *a, **k)
        was = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = onednn
        try:
            c, inv_K, _ = augment_batch(cfg, torch.from_numpy(colors), torch.from_numpy(K), draws=None)
            c = {key: v.to(dtype) for key, v in c.items()}
            inv_K = {key: v.to(dtype) for key, v in inv_K.items()}
            loss, _ = TT.loss_from_batch(cfg, nets, c, inv_K, torch.from_numpy(masks).to(dtype))
            g = torch.autograd.grad(loss, list(nets.mobile.parameters()))
        finally:
            torch.Tensor.float = float_
            torch.backends.mkldnn.enabled = was
        return float(torch.sqrt(sum((x.double() ** 2).sum() for x in g)))

    ref = port(torch.float64, False)
    norms = {"port_float64": ref, "port_float32_native": port(torch.float32, False),
             "port_float32_onednn": port(torch.float32, True), "jax_float32_grads_summed_in_float64": jax_grads_f64,
             "jax_step_reported": float(metrics["grad_norm"])}
    return {"values": norms, "rel_to_float64": {k: (v - ref) / ref for k, v in norms.items()}}


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps({"conv_weight_grad_rel_err": conv_errors(), "grad_norm": ds_norms(),
                      "torch": torch.__version__, "jax": jax.__version__}))
