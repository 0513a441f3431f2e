"""Training core: the model bundle, the optimizer and the train step — the
port of ``mdn_sfm_tpu.training``.

Per step: on-device augment → ONE 2B-stacked forward of the frozen FlowNet
and PoseNet (``torch.no_grad``, eval-mode BN — the counterpart of the JAX
package's ``stop_gradient``) and of the trainable MobileDecoder → the
multi-scale loss, whose epipolar maps go through the CUDA kernel on the card
→ gradients on the mobile decoder → global-norm clip → Adam → cosine LR.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .config import Config
from .data.augment import augment_batch
from .geometry import transformation_from_parameters
from .losses import LossAux, compute_losses
from .models import FlowNet, MobileDecoder, PoseNet
from .utils import resolve_device, use_full_f32

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

    FlowNet and PoseNet are frozen: ``.eval()`` (running-average BN) and no
    gradients. On the card the nets are kept channels-last for cuDNN."""
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
        m.eval().requires_grad_(False)
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


def split_trainable(cfg: Config, models: ModelBundle) -> dict[str, dict[str, torch.nn.Parameter]]:
    """{net: {name: parameter}} of what the optimizer updates: only the
    mobile decoder (flow/pose are frozen pretrained nets)."""
    return {"mobile_decoder": dict(models.mobile.named_parameters())}


# ----------------------------------------------------------------- optimizer


def lr_schedule(cfg: Config, steps_per_epoch: int):
    """LR at update k (k from 0, as optax counts): cosine decay over the run
    (optax.cosine_decay_schedule), or the reference's per-epoch oscillation
    η₀·(1+cos(2π·t))/2 with ``legacy_lr_schedule``."""
    if steps_per_epoch <= 0:
        return lambda k: cfg.learning_rate
    if cfg.legacy_lr_schedule:
        return lambda k: cfg.learning_rate * 0.5 * (1.0 + math.cos(2.0 * math.pi * k / steps_per_epoch))
    total = max(steps_per_epoch * cfg.num_epochs, 1)
    return lambda k: cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * min(k, total) / total))


def global_norm(tensors: list[Tensor]) -> Tensor:
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class Adam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr, b1, b2, eps=1e-8))``
    — or adamw with ``weight_decay`` — written out so the arithmetic matches
    optax: the clip scales g by max/‖g‖ only when ‖g‖ ≥ max (no epsilon, unlike
    ``clip_grad_norm_``), bias correction uses the incremented count, and the
    LR of update k is ``lr(k)`` with k from 0 — k is ``count``, optax's own
    count, so a fresh Adam restarts the schedule as optax's does. Updates run
    on the device with no host sync."""

    def __init__(self, params: list[torch.nn.Parameter], lr, b1: float, b2: float,
                 clip: float, weight_decay: float = 0.0, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.clip, self.wd, self.eps = lr, b1, b2, clip, weight_decay, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s layout: per parameter index ``step``,
        ``exp_avg`` (μ) and ``exp_avg_sq`` (ν), and one param group. The
        tensors are the live ones; copy them before the next step if they
        must outlive it. (With ``weight_decay`` the update is optax's
        decoupled adamw, recorded as ``decoupled_weight_decay``.)"""
        state = {
            i: {"step": torch.tensor(float(self.count)), "exp_avg": mu, "exp_avg_sq": nu}
            for i, (mu, nu) in enumerate(zip(self.mu, self.nu))
        }
        group = {"lr": float(self.lr(self.count)), "betas": (self.b1, self.b2), "eps": self.eps,
                 "weight_decay": self.wd, "decoupled_weight_decay": self.wd > 0, "amsgrad": False,
                 "maximize": False, "foreach": None, "capturable": False, "differentiable": False,
                 "fused": None, "params": list(range(len(self.params)))}
        return {"state": state, "param_groups": [group]}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore μ, ν and ``count`` from :meth:`state_dict`'s layout (an
        empty ``state``, as a ``torch.optim.Adam`` that never stepped saves,
        is a fresh Adam). Raises when the parameters do not match."""
        state = sd["state"]
        if not state:
            self.count = 0
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
        self.count = int(state[0]["step"])

    @torch.no_grad()
    def step(self, grads: list[Tensor]) -> Tensor:
        """Apply one update from ``grads``; returns the pre-clip global norm."""
        g_norm = global_norm(grads)
        keep = g_norm < self.clip  # decided on the device: no host sync
        grads = [torch.where(keep, g, g / g_norm * self.clip) for g in grads]
        self.count += 1
        # bias corrections in float32, as optax computes them: 1 − 0.999 in
        # f32 is off by 1.3e-5 relative, and that shows in every update
        one, k = np.float32(1.0), np.float32(self.count)
        bc1 = float(one - np.float32(self.b1) ** k)
        bc2 = float(one - np.float32(self.b2) ** k)
        lr = self.lr(self.count - 1)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.wd > 0:
                upd = upd + self.wd * p
            p.sub_(lr * upd)
        return g_norm


def make_optimizer(cfg: Config, models: ModelBundle, steps_per_epoch: int) -> Adam:
    """clip-by-global-norm → Adam(β₁=momentum, β₂=beta) on the trainable params."""
    params = [p for group in split_trainable(cfg, models).values() for p in group.values()]
    return Adam(params, lr_schedule(cfg, steps_per_epoch), cfg.momentum, cfg.beta,
                cfg.clip_grad, cfg.weight_decay)


# ------------------------------------------------------------- forward pass


def _autocast(cfg: Config, device: torch.device):
    if cfg.compute_dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


def forward_frame(
    cfg: Config, models: ModelBundle, tgt: Tensor, ref: Tensor
) -> tuple[dict, dict, Tensor, Tensor, Tensor]:
    """One (stacked) target/reference pair through flow + pose + mobile.

    tgt/ref: (N, H, W, 3) NHWC. Returns (flows {s: (N, Hs, Ws, 2)}, mobiles
    {s: (N, Hs, Ws, 1)}, axisangle, translation, cam_T_cam), NHWC views of
    the nets' NCHW outputs. Flow and pose run frozen: no graph, eval BN."""
    a, b = tgt.permute(0, 3, 1, 2), ref.permute(0, 3, 1, 2)
    with _autocast(cfg, tgt.device):
        with torch.no_grad():
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
    — as in the JAX package."""
    tgt = colors[(0, 0)]
    frame_ids = cfg.ref_frame_ids
    nf = len(frame_ids)
    b = tgt.shape[0]

    def _interleave(frames):  # nf × (B, …) → (B·nf, …)
        return torch.stack(frames, 1).reshape((b * nf,) + frames[0].shape[1:])

    def _deinterleave(x, fi):  # (B·nf, …) → (B, …), frame fi
        return x.reshape((b, nf) + x.shape[1:])[:, fi]

    f_all, m_all, _, _, cam_all = forward_frame(
        cfg, models, _interleave([tgt] * nf), _interleave([colors[(i, 0)] for i in frame_ids])
    )
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


def train_step(
    cfg: Config,
    models: ModelBundle,
    opt: Adam,
    batch: dict,
    generator: torch.Generator | None = None,
    draws: dict | None = None,
    provider=None,
) -> tuple[dict[str, Tensor], LossAux]:
    """One optimizer step on ``batch`` = {'colors_u8': (B, F, H, W, 3) uint8,
    'K': (B, 4, 4)[, 'instance_mask': (B, Hm, Wm)]}, on the batch's device.

    Augmentation draws come from ``draws`` or ``generator`` (per step:
    :func:`step_generator`). With a live mask ``provider`` (``union_fn``,
    ``d2_fuse_step``) and no mask in the batch, the DS/DC instance masks are
    inferred inside the step, with no graph, from the AUGMENTED target frame
    ×255 — the frame the reference's detectron2 sees. Returns (metrics, aux)
    as the JAX step does: the metrics as 0-d device tensors
    (loss/epip/smooth/consis[/photo], grad_norm; reading one syncs) and the
    loss's :class:`LossAux` maps, detached. Its stages carry the labels of
    :data:`STAGES` for ``torch.profiler``."""
    with record_function("augment"):
        colors, inv_Ks, raw0 = augment_batch(cfg, batch["colors_u8"], batch["K"], draws=draws,
                                             generator=generator)
    instance_mask = batch.get("instance_mask")
    if instance_mask is None and provider is not None:
        with record_function("instance_masks"):
            instance_mask = provider.union_fn(raw0 * 255.0)  # no graph: union_fn runs under no_grad
    with record_function("forward_loss"):
        loss, (losses, aux) = loss_from_batch(cfg, models, colors, inv_Ks, instance_mask)
    with record_function("backward"):
        grads = torch.autograd.grad(loss, opt.params)
    with record_function("optimizer"):
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = opt.step(list(grads))
    aux = LossAux(*({k: v.detach() for k, v in d.items()} for d in aux))
    return metrics, aux


@torch.no_grad()
def eval_forward(
    cfg: Config, models: ModelBundle, tgt: Tensor, ref: Tensor
) -> tuple[dict, dict, Tensor, Tensor, Tensor]:
    """The eval forward on a normalized (N, H, W, 3) image pair, the
    counterpart of the JAX package's ``make_eval_forward``: (flows {s: (N,
    Hs, Ws, 2)}, mobiles {s: (N, Hs, Ws, 1)}, axisangle, translation,
    cam_T_cam), with no graph."""
    return forward_frame(cfg, models, tgt, ref)


@torch.no_grad()
def eval_pose(cfg: Config, models: ModelBundle, tgt: Tensor, ref: Tensor) -> Tensor:
    """The pose net alone on a normalized (N, H, W, 3) pair → cam_T_cam (N,
    4, 4) float32, with no graph: the forward of ``evaluate_pose``."""
    with _autocast(cfg, tgt.device):
        aa, t = models.pose(tgt.permute(0, 3, 1, 2), ref.permute(0, 3, 1, 2))
    return transformation_from_parameters(aa, t)
