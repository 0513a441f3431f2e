"""Training core: the model bundle, the optimizer and the train step — the
port of ``mdn_sfm_tpu.training``.

Per step: on-device augment → ONE 2B-stacked forward of FlowNet, PoseNet
and the trainable MobileDecoder → the multi-scale loss → gradients →
global-norm clip → Adam → cosine LR.

By default flow and pose are frozen (``torch.no_grad``, the counterpart of
the JAX package's ``stop_gradient``; eval-mode BN), and the loss's epipolar
maps go through the CUDA kernel on the card. The step options of the JAX
package:

* ``fine_tune_flow_motion``: flow and pose train too, and the maps are the
  plain version with autograd (as the JAX package takes plain XLA there);
* ``bn_frozen_eval=False``: their BatchNorm normalizes with the stacked 2B
  batch's statistics and updates the running averages (Flax's update);
* ``remat``: the stacked forward is rematerialized in backward
  (``torch.utils.checkpoint``), its BN averages updated once;
* ``accum_steps``: the batch runs as that many microbatches, with one Adam
  update on the mean gradient;
* ``skip_nonfinite_updates``: a step with a NaN/Inf gradient changes
  nothing (``optax.apply_if_finite``).

With a process group (``group``, :mod:`.parallel`) the step is the JAX
package's ``shard_map`` step: each rank takes its rows of the global batch
and their augmentation draws, and one all-reduce a step averages the
gradients, the loss scalars and, with train-mode BN, the BatchNorm running
averages before Adam; ``grad_norm`` is the norm of the averaged gradient.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .config import Config
from .data.augment import augment_batch, draw_augment
from .geometry import transformation_from_parameters
from .losses import LossAux, compute_losses
from .models import FlowNet, MobileDecoder, PoseNet
from .models.resnet import BatchNorm2d
from .parallel.data_parallel import all_reduce_mean, group_rank_and_size, local_rows
from .utils import divisor, resolve_device, use_full_f32

Tensor = torch.Tensor


class ModelBundle(NamedTuple):
    flow: FlowNet
    pose: PoseNet
    mobile: MobileDecoder


def build_models(
    cfg: Config, generator: torch.Generator | None = None, device: str | torch.device | None = None
) -> ModelBundle:
    """The three networks, initialized from ``generator`` (seeded with
    ``cfg.seed`` when None), on ``device`` (``cuda`` unless asked otherwise).

    FlowNet and PoseNet rest in ``.eval()`` (running-average BN; the train
    forward switches their BN to train mode when ``bn_frozen_eval`` is
    off) and take gradients only with ``fine_tune_flow_motion``. On the card
    the nets are kept channels-last for cuDNN."""
    device = resolve_device(device)
    if device.type == "cuda":
        use_full_f32()  # f32 convs/matmuls stay f32; bf16 runs use autocast
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    models = ModelBundle(
        flow=FlowNet(num_layers=18, use_elu=cfg.use_elu, scales=tuple(cfg.scales)),
        pose=PoseNet(num_layers=cfg.num_layers, use_elu=False),
        mobile=MobileDecoder(scales=tuple(cfg.scales), use_elu=cfg.use_elu),
    )
    init_variables(models, generator)
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    for m in models:
        m.to(device=device, memory_format=fmt)
    for m in (models.flow, models.pose):
        m.eval().requires_grad_(cfg.fine_tune_flow_motion)
    models.mobile.train()
    return models


def modules_by_name(models: ModelBundle) -> dict[str, torch.nn.Module]:
    """{checkpoint name: module}: ``flownet``, ``posenet``, ``mobile_decoder``."""
    return {"flownet": models.flow, "posenet": models.pose, "mobile_decoder": models.mobile}


def load_eval_models(cfg: Config, device: str | torch.device | None = None,
                     nets: tuple[str, ...] = ("flownet", "posenet", "mobile_decoder")) -> ModelBundle:
    """The networks of an eval CLI on ``device``, all in eval mode: flow and
    pose from ``cfg.load_weights_folder``, the mobile decoder from
    ``{log_dir}/{version}/models/weights_{idx}``, those of ``nets`` only."""
    from . import checkpoints as ckpt

    models = build_models(cfg, device=device)
    models.mobile.eval()
    mods = modules_by_name(models)
    frozen = tuple(n for n in nets if n != "mobile_decoder")
    folders = [cfg.load_weights_folder]
    ckpt.load_into(cfg.load_weights_folder, mods, frozen)
    if "mobile_decoder" in nets:
        folders.append(ckpt.weights_folder(cfg.log_dir, cfg.version, cfg.idx))
        ckpt.load_into(folders[-1], mods, ("mobile_decoder",))
    print("-> Loading weights from\n" + "\n".join(folders))
    return models


def init_variables(models: ModelBundle, generator: torch.Generator) -> None:
    """(Re-)initialize every parameter and buffer from ``generator`` with the
    JAX package's initializers (kaiming fan-out encoders, xavier decoders,
    lecun pose head)."""
    for m in models:
        m.init_weights(generator)


def trainable_nets(cfg) -> tuple[str, ...]:
    """The nets the optimizer updates, in the order ``Adam`` and ``adam.pth``
    index their parameters: the mobile decoder, then, with
    ``fine_tune_flow_motion``, ``flownet`` and ``posenet``; each net's
    parameters in ``named_parameters`` order. So the decoder's parameters
    keep indices 0 … n−1 in both settings."""
    return ("mobile_decoder", "flownet", "posenet") if cfg.fine_tune_flow_motion else ("mobile_decoder",)


def split_trainable(cfg, models: ModelBundle) -> dict[str, dict[str, torch.nn.Parameter]]:
    """{net: {name: parameter}} of what the optimizer updates, in
    :func:`trainable_nets`' order: the mobile decoder, and flow and pose
    when fine-tuning (their BatchNorm running statistics stay buffers)."""
    mods = modules_by_name(models)
    return {n: dict(mods[n].named_parameters()) for n in trainable_nets(cfg)}


def trainable_param_names(cfg) -> dict[str, list[str]]:
    """{net: parameter names} in the optimizer's order, from the nets'
    shapes alone (built on the CPU, no weights read): what
    ``weights.adam_state_from_optax`` maps optax's moments onto. ``cfg``
    may be either package's Config (it reads ``fine_tune_flow_motion``,
    ``num_layers``, ``use_elu`` and ``scales``)."""
    models = ModelBundle(
        flow=FlowNet(num_layers=18, use_elu=cfg.use_elu, scales=tuple(cfg.scales)),
        pose=PoseNet(num_layers=cfg.num_layers, use_elu=False),
        mobile=MobileDecoder(scales=tuple(cfg.scales), use_elu=cfg.use_elu),
    )
    return {n: list(params) for n, params in split_trainable(cfg, models).items()}


# ----------------------------------------------------------------- optimizer


def _cos(x):
    return torch.cos(x) if torch.is_tensor(x) else math.cos(x)


def _at_most(x, top: int):
    return torch.clamp(x, max=top) if torch.is_tensor(x) else min(x, top)


def lr_schedule(cfg: Config, steps_per_epoch: int):
    """LR at update k (k from 0, as optax counts): cosine decay over the run
    (optax.cosine_decay_schedule), or the reference's per-epoch oscillation
    η₀·(1+cos(2π·t))/2 with ``legacy_lr_schedule``. k is a Python number
    (the result is a float) or a float64 tensor on the device (the result
    is one there: Adam reads its count on the device, with no host sync)."""
    lr0 = cfg.learning_rate
    if steps_per_epoch <= 0:
        return lambda k: torch.full_like(k, lr0) if torch.is_tensor(k) else lr0
    if cfg.legacy_lr_schedule:
        return lambda k: lr0 * 0.5 * (1.0 + _cos(2.0 * math.pi * k / steps_per_epoch))
    total = max(steps_per_epoch * cfg.num_epochs, 1)
    return lambda k: lr0 * 0.5 * (1.0 + _cos(math.pi * _at_most(k, total) / total))


def global_norm(tensors: list[Tensor]) -> Tensor:
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class Adam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr, b1, b2, eps=1e-8))``
    — or adamw with ``weight_decay`` — written out so the arithmetic matches
    optax: the clip scales g by max/‖g‖ only when ‖g‖ ≥ max (no epsilon, unlike
    ``clip_grad_norm_``), bias correction uses the incremented count, and the
    LR of update k is ``lr(k)`` with k from 0 — k is ``count``, optax's own
    count, so a fresh Adam restarts the schedule as optax's does.

    ``skip_nonfinite`` wraps the chain as ``optax.apply_if_finite(…,
    MAX_CONSECUTIVE_ERRORS)`` does: a step whose gradients hold a NaN or an
    Inf leaves the params, μ, ν and the count as they were and counts
    ``notfinite_count`` (consecutive) and ``total_notfinite``; once more
    than ``MAX_CONSECUTIVE_ERRORS`` such steps follow each other, the next
    ones apply, non-finite values and all, as optax's do.

    The count, the LR, the bias corrections and the skip decision live on
    the params' device: a step makes no host sync."""

    MAX_CONSECUTIVE_ERRORS = 100  # the JAX package's apply_if_finite setting

    def __init__(self, params: list[torch.nn.Parameter], lr, b1: float, b2: float,
                 clip: float, weight_decay: float = 0.0, eps: float = 1e-8, skip_nonfinite: bool = False):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.clip, self.wd, self.eps = lr, b1, b2, clip, weight_decay, eps
        self.skip_nonfinite = skip_nonfinite
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device
        self._count = torch.zeros((), dtype=torch.int64, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int64, device=dev)
        self.total_notfinite = torch.zeros((), dtype=torch.int64, device=dev)
        self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        # the βs as optax holds them, float32, for the bias corrections
        self._b32 = float(np.float32(b1)), float(np.float32(b2))

    @property
    def count(self) -> int:
        """Updates applied so far (reading it syncs with the device)."""
        return int(self._count)

    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s layout: per parameter index ``step``,
        ``exp_avg`` (μ) and ``exp_avg_sq`` (ν), and one param group. The
        tensors are the live ones; copy them before the next step if they
        must outlive it. (With ``weight_decay`` the update is optax's
        decoupled adamw, recorded as ``decoupled_weight_decay``; with
        ``skip_nonfinite`` the group also holds ``notfinite_count``,
        ``last_finite`` and ``total_notfinite``, which ``torch.optim.Adam``
        keeps and ignores.)"""
        count = self.count
        state = {
            i: {"step": torch.tensor(float(count)), "exp_avg": mu, "exp_avg_sq": nu}
            for i, (mu, nu) in enumerate(zip(self.mu, self.nu))
        }
        group = {"lr": float(self.lr(count)), "betas": (self.b1, self.b2), "eps": self.eps,
                 "weight_decay": self.wd, "decoupled_weight_decay": self.wd > 0, "amsgrad": False,
                 "maximize": False, "foreach": None, "capturable": False, "differentiable": False,
                 "fused": None, "params": list(range(len(self.params)))}
        if self.skip_nonfinite:
            group.update(notfinite_count=int(self.notfinite_count), last_finite=bool(self.last_finite),
                         total_notfinite=int(self.total_notfinite))
        return {"state": state, "param_groups": [group]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore μ, ν, ``count`` and the skip counters from
        :meth:`state_dict`'s layout (an empty ``state``, as a
        ``torch.optim.Adam`` that never stepped saves, is a fresh Adam; a
        file without the skip counters starts them at 0). Raises when the
        parameters do not match."""
        state = sd["state"]
        group = sd["param_groups"][0] if sd.get("param_groups") else {}
        self.notfinite_count.fill_(int(group.get("notfinite_count", 0)))
        self.total_notfinite.fill_(int(group.get("total_notfinite", 0)))
        self.last_finite.fill_(bool(group.get("last_finite", True)))
        if not state:
            self._count.zero_()
            for t in self.mu + self.nu:
                t.zero_()
            return
        if sorted(state) != list(range(len(self.params))):
            raise ValueError(f"Adam state for {len(state)} parameters, this optimizer has {len(self.params)}")
        for i, (mu, nu) in enumerate(zip(self.mu, self.nu)):
            s = state[i]
            if tuple(s["exp_avg"].shape) != tuple(mu.shape) or tuple(s["exp_avg_sq"].shape) != tuple(nu.shape):
                raise ValueError(f"Adam state of parameter {i} has shape {tuple(s['exp_avg'].shape)}, "
                                 f"the parameter {tuple(mu.shape)}")
            mu.copy_(s["exp_avg"])
            nu.copy_(s["exp_avg_sq"])
        self._count.fill_(int(state[0]["step"]))

    def _apply_flag(self, grads: list[Tensor]) -> Tensor:
        """optax.apply_if_finite's decision, on the device: count this step's
        finiteness and return whether it applies."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        zero = torch.zeros_like(self.notfinite_count)
        self.notfinite_count.copy_(torch.where(finite, zero, self.notfinite_count + 1))
        self.total_notfinite.add_((~finite).long())
        self.last_finite.copy_(finite)
        return finite | (self.notfinite_count > self.MAX_CONSECUTIVE_ERRORS)

    @torch.no_grad()
    def step(self, grads: list[Tensor]) -> Tensor:
        """Apply one update from ``grads``; returns the pre-clip global norm."""
        apply = self._apply_flag(grads) if self.skip_nonfinite else None
        g_norm = global_norm(grads)
        keep = g_norm < self.clip  # decided on the device: no host sync
        grads = [torch.where(keep, g, g / g_norm * self.clip) for g in grads]
        k = self._count.double()
        lr = self.lr(k)  # the LR of update k, k from 0
        if not torch.is_tensor(lr):
            lr = torch.full((), lr, dtype=torch.float64, device=k.device)
        # bias corrections in float32 with the incremented count, as optax
        # computes them: 1 − 0.999 in f32 is off by 1.3e-5 relative, and that
        # shows in every update. β^(k+1) in float64, rounded once to float32
        bc1 = 1.0 - torch.pow(self._b32[0], k + 1).float()
        bc2 = 1.0 - torch.pow(self._b32[1], k + 1).float()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            # in place, unless a skipped step must leave μ and ν as they are
            m = (mu.mul_ if apply is None else mu.mul)(self.b1).add_(g, alpha=1.0 - self.b1)
            v = (nu.mul_ if apply is None else nu.mul)(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.wd > 0:
                upd = upd + self.wd * p
            if apply is None:
                p.sub_(lr * upd)
                continue
            mu.copy_(torch.where(apply, m, mu))
            nu.copy_(torch.where(apply, v, nu))
            p.copy_(torch.where(apply, p - lr * upd, p))
        self._count.add_(1 if apply is None else apply.long())
        return g_norm


def make_optimizer(cfg: Config, models: ModelBundle, steps_per_epoch: int) -> Adam:
    """clip-by-global-norm → Adam(β₁=momentum, β₂=beta) on the trainable params."""
    params = [p for group in split_trainable(cfg, models).values() for p in group.values()]
    return Adam(params, lr_schedule(cfg, steps_per_epoch), cfg.momentum, cfg.beta,
                cfg.clip_grad, cfg.weight_decay, skip_nonfinite=cfg.skip_nonfinite_updates)


# ------------------------------------------------------------- forward pass


def _autocast(cfg: Config, device: torch.device):
    if cfg.compute_dtype == "bfloat16":
        # under CUDA graph capture the casts of the weights must be captured
        # anew in every step: the cast cache would hand a replay the bf16
        # copies cast once, before the optimizer moved the weights
        capturing = device.type == "cuda" and torch.cuda.is_current_stream_capturing()
        return torch.autocast(device.type, dtype=torch.bfloat16, cache_enabled=not capturing)
    return contextlib.nullcontext()


@contextlib.contextmanager
def _native_cpu_convs(device: torch.device):
    """On the CPU, PyTorch's own convolutions instead of oneDNN's within the
    block. oneDNN's weight gradient of a 3×3 conv sums the spatial positions
    less precisely: 2.8e-6 relative to float64 over 4×64×96 positions against
    3.9e-7, and the DS step's gradient norm 2.3e-5 from float64 against 7.8e-8
    (``tests/torch_grad_probe.py``; the JAX package's gradients lie 4.5e-7
    from it)."""
    if device.type != "cpu":
        yield
        return
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


@contextlib.contextmanager
def _bn_train(models: ModelBundle):
    """Flow's and pose's BatchNorm in train mode within the block."""
    nets = (models.flow, models.pose)
    was = [m.training for m in nets]
    for m in nets:
        m.train()
    try:
        yield
    finally:
        for m, w in zip(nets, was):
            m.train(w)


@contextlib.contextmanager
def _bn_replay(models: ModelBundle):
    """Flow's and pose's BatchNorm replaying within the block (a remat
    recompute): batch statistics, running averages left as they are."""
    bns = [b for m in (models.flow, models.pose) for b in m.modules() if isinstance(b, BatchNorm2d)]
    for b in bns:
        b.replay = True
    try:
        yield
    finally:
        for b in bns:
            b.replay = False


def forward_frame(
    cfg: Config, models: ModelBundle, tgt: Tensor, ref: Tensor, train: bool = True
) -> tuple[dict, dict, Tensor, Tensor, Tensor]:
    """One (stacked) target/reference pair through flow + pose + mobile.

    tgt/ref: (N, H, W, 3) NHWC. Returns (flows {s: (N, Hs, Ws, 2)}, mobiles
    {s: (N, Hs, Ws, 1)}, axisangle, translation, cam_T_cam), NHWC views of
    the nets' NCHW outputs. Flow and pose run with no graph unless
    ``fine_tune_flow_motion``, and with train-mode BN over the stacked
    batch (updating their running averages) when ``bn_frozen_eval`` is off;
    ``train=False`` (the eval forward) runs them with no graph and their
    running averages in every setting, as the JAX package's eval forward
    applies ``train=False``."""
    a, b = tgt.permute(0, 3, 1, 2), ref.permute(0, 3, 1, 2)
    grad = contextlib.nullcontext() if train and cfg.fine_tune_flow_motion else torch.no_grad()
    bn = _bn_train(models) if train and not cfg.bn_frozen_eval else contextlib.nullcontext()
    with _autocast(cfg, tgt.device):
        with grad, bn:
            flows, feats = models.flow(a, b)
            aa, t = models.pose(a, b)
        mobiles = models.mobile(feats, aa, t)
    cam = transformation_from_parameters(aa, t)
    return (
        {s: _nhwc(f) for s, f in flows.items()},
        {s: _nhwc(m) for s, m in mobiles.items()},
        aa, t, cam,
    )


def loss_from_batch(
    cfg: Config,
    models: ModelBundle,
    colors: dict,
    inv_Ks: dict,
    instance_mask: Optional[Tensor],
) -> tuple[Tensor, tuple[dict, LossAux]]:
    """Forward both reference frames as ONE 2B-batch and compute the loss.
    Frames interleave frame-minor — sample b's frames at rows [b·F, (b+1)·F)
    — as in the JAX package. With ``remat`` the forward is checkpointed:
    backward replays it instead of keeping its activations, with the BN
    running averages left as the first forward updated them."""
    tgt = colors[(0, 0)]
    frame_ids = cfg.ref_frame_ids
    nf = len(frame_ids)
    b = tgt.shape[0]

    def _interleave(frames):  # nf × (B, …) → (B·nf, …)
        return torch.stack(frames, 1).reshape((b * nf,) + frames[0].shape[1:])

    def _deinterleave(x, fi):  # (B·nf, …) → (B, …), frame fi
        return x.reshape((b, nf) + x.shape[1:])[:, fi]

    tgt_rep, refs = _interleave([tgt] * nf), _interleave([colors[(i, 0)] for i in frame_ids])
    if cfg.remat:
        f_all, m_all, _, _, cam_all = checkpoint(
            forward_frame, cfg, models, tgt_rep, refs, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(), _bn_replay(models)))
    else:
        f_all, m_all, _, _, cam_all = forward_frame(cfg, models, tgt_rep, refs)
    flows, mobiles, cams = {}, {}, {}
    for fi, i in enumerate(frame_ids):
        for s in cfg.scales:
            flows[(i, s)] = _deinterleave(f_all[s], fi)
            mobiles[(i, s)] = _deinterleave(m_all[s], fi)
        cams[i] = _deinterleave(cam_all, fi)

    losses, aux = compute_losses(cfg, colors, inv_Ks, flows, mobiles, cams, instance_mask)
    return losses["loss"], (losses, aux)


# --------------------------------------------------------------- train step

# the stages of train_step, as torch.profiler labels them ("instance_masks"
# only with a fused mask provider)
STAGES = ("augment", "instance_masks", "forward_loss", "backward", "optimizer")


def step_generator(seed: int, step: int, device: str | torch.device) -> torch.Generator:
    """The augmentation generator of step ``step``: seeded from (seed, step)
    alone, as the JAX step folds its step counter into its key, so a run
    that is interrupted and resumed draws what an uninterrupted one draws.
    The pair is hashed: the CPU generator keeps only a seed's low 32 bits."""
    digest = hashlib.blake2b(f"{seed},{step}".encode(), digest_size=8).digest()
    return torch.Generator(device=device).manual_seed(int.from_bytes(digest, "little") >> 1)


def _micro_grads(cfg: Config, models: ModelBundle, opt: Adam, batch: dict, draws: dict | None, provider,
                 n_micro: int) -> tuple[list[Tensor], list]:
    """Forward and backward of each of ``n_micro`` microbatches in order:
    the summed gradients and each microbatch's (losses, aux), detached."""
    mb = batch["colors_u8"].shape[0] // n_micro
    grads, parts = None, []
    for a in range(n_micro):
        rows = slice(a * mb, (a + 1) * mb)
        part = {k: v[rows] for k, v in batch.items()} if n_micro > 1 else batch
        part_draws = {k: v[rows] for k, v in draws.items()} if draws is not None and n_micro > 1 else draws
        with record_function("augment"):
            colors, inv_Ks, raw0 = augment_batch(cfg, part["colors_u8"], part["K"], draws=part_draws)
        instance_mask = part.get("instance_mask")
        if instance_mask is None and provider is not None:
            with record_function("instance_masks"):
                instance_mask = provider.union_fn(raw0 * 255.0)  # no graph: union_fn runs under no_grad
        with record_function("forward_loss"):
            loss, (losses, aux) = loss_from_batch(cfg, models, colors, inv_Ks, instance_mask)
        with record_function("backward"):
            g = torch.autograd.grad(loss, opt.params)
        grads = list(g) if grads is None else [x + y for x, y in zip(grads, g)]
        parts.append(({k: v.detach() for k, v in losses.items()},
                      LossAux(*({k: v.detach() for k, v in d.items()} for d in aux))))
    return grads, parts


def _bn_statistics(models: ModelBundle) -> list[Tensor]:
    """Flow's and pose's BatchNorm running averages: the JAX step's
    ``batch_stats``."""
    return [t for m in (models.flow, models.pose) for bn in m.modules() if isinstance(bn, BatchNorm2d)
            for t in (bn.running_mean, bn.running_var)]


def _reduce_over_group(cfg: Config, models: ModelBundle, grads: list[Tensor], metrics: dict, group
                       ) -> tuple[list[Tensor], dict]:
    """The data-parallel step's one all-reduce, the JAX step's ``pmean``s:
    the mean over the group of the gradients, the loss scalars and, with
    train-mode BN, flow's and pose's running averages (written back in
    place). Returns the averaged gradients and loss scalars."""
    stats = [] if cfg.bn_frozen_eval else _bn_statistics(models)
    keys = list(metrics)
    out = all_reduce_mean(grads + [metrics[k] for k in keys] + stats, group)
    n, m = len(grads), len(keys)
    with torch.no_grad():
        for t, v in zip(stats, out[n + m:]):
            t.copy_(v)
    return out[:n], dict(zip(keys, out[n:n + m]))


def train_step(
    cfg: Config,
    models: ModelBundle,
    opt: Adam,
    batch: dict,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    provider=None,
    group=None,
) -> tuple[dict[str, Tensor], LossAux]:
    """One optimizer step on ``batch`` = {'colors_u8': (B, F, H, W, 3) uint8,
    'K': (B, 4, 4)[, 'instance_mask': (B, Hm, Wm)]}, on the batch's device.

    Augmentation draws come from ``draws`` or ``generator`` (per step:
    :func:`step_generator`), made once for the whole batch. With
    ``accum_steps`` = A the batch runs as A microbatches of B/A samples in
    order, each with its slice of the draws (so each sample sees the draw
    it gets at A = 1): forward and backward per microbatch, the gradients
    summed and divided by A, one Adam update; the losses are the
    microbatches' mean and aux is restacked to the whole batch. With a live
    mask ``provider`` (``union_fn``, ``d2_fuse_step``) and no mask in the
    batch, the DS/DC instance masks are inferred inside the step, with no
    graph, from the AUGMENTED target frame ×255 — the frame the reference's
    detectron2 sees. Returns (metrics, aux) as the JAX step does: the
    metrics as 0-d device tensors (loss/epip/smooth/consis[/photo],
    grad_norm; reading one syncs) and the loss's :class:`LossAux` maps,
    detached. Its stages carry the labels of :data:`STAGES` for
    ``torch.profiler``.

    With a process ``group`` (``torch.distributed``; NCCL on the card, gloo
    on the CPU) ``batch`` is this rank's rows of the global batch, the
    ``generator`` draws the global batch's augmentation and the rank keeps
    its rows of it (so each sample gets the draw it gets in a one-process
    step on the global batch; ``draws``, when given, are the rank's rows),
    and the gradients, the loss scalars and the train-mode BN averages are
    averaged over the group in one all-reduce before Adam, which every rank
    then applies alike. The metrics are the group's means and aux is the
    rank's own rows."""
    colors_u8 = batch["colors_u8"]
    b, _, h, w, _ = colors_u8.shape
    n_micro = cfg.accum_steps
    if b % n_micro:
        raise ValueError(f"batch {b} must divide by accum_steps {n_micro}")
    rank, world = group_rank_and_size(group)
    if draws is None and not cfg.disable_augment:
        if generator is None:
            raise ValueError("train_step needs draws or a generator")
        with record_function("augment"):
            draws = {k: local_rows(v, rank, world) for k, v in draw_augment(b * world, h, w, generator).items()}
    with _native_cpu_convs(colors_u8.device):
        grads, parts = _micro_grads(cfg, models, opt, batch, draws, provider, n_micro)
    with record_function("optimizer"):
        if n_micro == 1:
            metrics, aux = parts[0]
        else:
            n = divisor(grads[0], float(n_micro))
            grads = [g / n for g in grads]
            metrics = {k: torch.stack([m[k] for m, _ in parts]).mean() for k in parts[0][0]}
            aux = LossAux(*({k: torch.cat([getattr(x, field)[k] for _, x in parts]) for k in d}
                            for field, d in zip(LossAux._fields, parts[0][1])))
        if group is not None:
            grads, metrics = _reduce_over_group(cfg, models, grads, metrics, group)
        metrics["grad_norm"] = opt.step(grads)
    return metrics, aux


def multi_step_draws(cfg: Config, batches: dict, step: int, group=None) -> dict[str, Tensor] | None:
    """The augmentation draws of the K steps of a dispatch from step ``step``
    on: step ``step + j`` draws from :func:`step_generator` (seed, step + j)
    on the batches' device, as a single step does, stacked to (K, B, …);
    with a process ``group``, the global batch's draws and this rank's rows
    of them. None with ``disable_augment``."""
    if cfg.disable_augment:
        return None
    colors_u8 = batches["colors_u8"]
    k, b, _, h, w, _ = colors_u8.shape
    rank, world = group_rank_and_size(group)
    per = [draw_augment(b * world, h, w, step_generator(cfg.seed, step + j, colors_u8.device)) for j in range(k)]
    return {key: torch.stack([local_rows(d[key], rank, world) for d in per]) for key in per[0]}


def k_train_steps(cfg: Config, models: ModelBundle, opt: Adam, batches: dict, draws: dict | None = None,
                  provider=None, group=None) -> tuple[dict[str, Tensor], LossAux, dict[str, Tensor]]:
    """:func:`train_step` on each of the K batches of ``batches`` (every
    entry (K, B, …)) in order, step j with row j of ``draws``, each through
    ``group`` when one is given (K all-reduces). Returns the
    metrics' mean over the K steps, the last step's aux, and the metrics of
    each step ({name: (K,)})."""
    k = batches["colors_u8"].shape[0]
    per, aux = [], None
    for j in range(k):
        step_draws = None if draws is None else {key: v[j] for key, v in draws.items()}
        metrics, aux = train_step(cfg, models, opt, {key: v[j] for key, v in batches.items()},
                                  draws=step_draws, provider=provider, group=group)
        per.append(metrics)
    steps = {key: torch.stack([m[key] for m in per]) for key in per[0]}
    return {key: v.mean() for key, v in steps.items()}, aux, steps


def make_multi_train_step(cfg: Config, models: ModelBundle, opt: Adam, k: int, provider=None, group=None):
    """K optimizer steps a dispatch, the counterpart of the JAX package's
    ``make_multi_train_step``: a callable on (K, B, …) batches and their
    draws (:func:`multi_step_draws`) that returns the K steps' mean metrics
    and the last step's :class:`LossAux`. On the card a dispatch is one
    replay of a CUDA graph captured over K steps (with a process ``group``,
    their K all-reduces inside it); on the CPU the K steps run in turn
    (:class:`~.dispatch.KStepDispatch`)."""
    from .dispatch import KStepDispatch

    return KStepDispatch(cfg, models, opt, k, provider, group)


@torch.no_grad()
def eval_forward(
    cfg: Config, models: ModelBundle, tgt: Tensor, ref: Tensor
) -> tuple[dict, dict, Tensor, Tensor, Tensor]:
    """The eval forward on a normalized (N, H, W, 3) image pair, the
    counterpart of the JAX package's ``make_eval_forward``: (flows {s: (N,
    Hs, Ws, 2)}, mobiles {s: (N, Hs, Ws, 1)}, axisangle, translation,
    cam_T_cam), with no graph and flow's and pose's running-average BN."""
    return forward_frame(cfg, models, tgt, ref, train=False)


@torch.no_grad()
def eval_pose(cfg: Config, models: ModelBundle, tgt: Tensor, ref: Tensor) -> Tensor:
    """The pose net alone on a normalized (N, H, W, 3) pair → cam_T_cam (N,
    4, 4) float32, with no graph: the forward of ``evaluate_pose``."""
    with _autocast(cfg, tgt.device):
        aa, t = models.pose(tgt.permute(0, 3, 1, 2), ref.permute(0, 3, 1, 2))
    return transformation_from_parameters(aa, t)
