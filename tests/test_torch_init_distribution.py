"""The port's initializers draw from the JAX package's distributions.

torch's generators cannot reproduce ``jax.random``, so a seed gives other
weights in each package; what must agree is the distribution each tensor
is drawn from (kaiming fan-out encoders, xavier decoders, lecun pose head,
constant BatchNorm and bias tensors). Over SEEDS draws of the three nets,
each tensor's standard deviation, averaged over the draws, lies within
STD_RTOL of JAX's, and a tensor JAX fills with a constant is that constant
in the port. (The synthetic rehearsal's phase 1 diverges for some seeds in
both packages: its per-seed outcome depends on these draws.)"""

import jax
import numpy as np
import pytest
import torch

from mdn_sfm_tpu import training as JT
from mdn_sfm_tpu.config import Config as JConfig, Mode as JMode
from mdn_sfm_tpu_torch import training as TT
from mdn_sfm_tpu_torch.config import Config, Mode
from mdn_sfm_tpu_torch.weights import state_dict_from_flax
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

NETS = ("flownet", "posenet", "mobile_decoder")
SEEDS = 4
# the std of n draws is off by about 1/sqrt(2n) relative: 2 % for the
# smallest tensor averaged over 4 draws (the 2×16×3×3 flow head), so 10 %
# is five times that
STD_RTOL = 0.1
KW = dict(height=64, width=128, batch_size=4, threshold=9.22, fine_tune_flow_motion=True, compute_dtype="float32")


@pytest.fixture(scope="module")
def draws():
    jcfg = JConfig(mode=JMode.T, **KW).validate()
    cfg = Config(mode=Mode.T, **KW).validate()
    jmodels = JT.build_models(jcfg)
    jax_sd, port_sd = [], []
    for s in range(SEEDS):
        v = jax.device_get(JT.init_variables(jcfg, jmodels, jax.random.PRNGKey(s)))
        jax_sd.append({f"{n}.{k}": x for n in NETS for k, x in state_dict_from_flax(n, v[n]).items()})
        models = TT.build_models(cfg, torch.Generator().manual_seed(s), "cpu")
        port_sd.append({f"{n}.{k}": x for n, m in zip(NETS, models) for k, x in m.state_dict().items()})
    return jax_sd, port_sd


@pytest.mark.parametrize("net", NETS)
def test_each_tensor_drawn_from_the_jax_distribution(draws, net):
    jax_sd, port_sd = draws
    names = [k for k in jax_sd[0] if k.startswith(net + ".")]
    assert names and set(names) == {k for k in port_sd[0] if k.startswith(net + ".")}
    for k in names:
        jstd = np.mean([float(d[k].float().std()) if d[k].numel() > 1 else 0.0 for d in jax_sd])
        if jstd == 0.0:  # a constant fill
            assert all(torch.equal(p[k].float(), j[k].float()) for p, j in zip(port_sd, jax_sd)), k
            continue
        pstd = np.mean([float(d[k].float().std()) for d in port_sd])
        assert abs(pstd / jstd - 1.0) <= STD_RTOL, (k, pstd, jstd)
