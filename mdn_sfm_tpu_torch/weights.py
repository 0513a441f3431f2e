"""Weights carried across from the JAX package: a Flax variable tree of numpy
arrays → the port's state dict, and optax's Adam state → the port's Adam.

The port's parameter names are the reference's (the names
``mdn_sfm_tpu.checkpoints.export_pth`` writes), so the result loads with
``load_state_dict(strict=True)``. This module keeps its own copy of that key
mapping and needs neither JAX nor the JAX package: pull the variables to the
host first (``jax.device_get``).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

NETS = ("flownet", "posenet", "mobile_decoder")

_BN_LEAF = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_POSE_INDEX = {"squeeze": 0, "pose_0": 1, "pose_1": 2, "pose_2": 3}
_HEADS = {"flownet": "pred_flow", "mobile_decoder": "pred_mobile"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, Any]:
    out: dict[tuple, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _conv_leaf(leaf: str) -> str:
    return {"kernel": "weight", "bias": "bias"}[leaf]


def _encoder_key(coll: str, path: tuple) -> str:
    """(collection, path under 'encoder') → torchvision trunk key."""
    if path[0] == "conv1":
        return "conv1.weight"
    if path[0] == "bn1":
        return f"bn1.{_BN_LEAF[(coll, path[1])]}"
    m = re.fullmatch(r"layer(\d)_(\d+)", path[0])
    if m is None:
        raise KeyError(path)
    block = f"layer{m.group(1)}.{m.group(2)}"
    name, leaf = path[1], path[-1]
    if name == "downsample_conv":
        return f"{block}.downsample.0.weight"
    if name == "downsample_bn":
        return f"{block}.downsample.1.{_BN_LEAF[(coll, leaf)]}"
    if name.startswith("conv"):
        return f"{block}.{name}.weight"
    if name.startswith("bn"):
        return f"{block}.{name}.{_BN_LEAF[(coll, leaf)]}"
    raise KeyError(path)


def _decoder_index(net: str, name: str) -> int:
    """upconv_{i}_{j} → (4 − i)·2 + j; pred_{flow,mobile}_{s} → 10 + s."""
    m = re.fullmatch(r"upconv_(\d)_(\d)", name)
    if m:
        return (4 - int(m.group(1))) * 2 + int(m.group(2))
    m = re.fullmatch(rf"{_HEADS[net]}_(\d)", name)
    if m:
        return 10 + int(m.group(1))
    raise KeyError(name)


def torch_key(net: str, coll: str, path: tuple) -> tuple[str, bool]:
    """Map one Flax variable (collection, path) to (state-dict key, is_conv_kernel)."""
    is_kernel = path[-1] == "kernel"
    if net in ("flownet", "posenet") and path[0] == "encoder":
        return "encoder.encoder." + _encoder_key(coll, path[1:]), is_kernel
    if net == "posenet" and path[0] == "decoder":
        return f"decoder.pose_net.{_POSE_INDEX[path[1]]}.{_conv_leaf(path[-1])}", is_kernel
    if net == "flownet" and path[0] == "decoder":
        # ('decoder', name, 'conv'[, 'conv'], leaf)
        idx = _decoder_index(net, path[1])
        inner = ".".join(path[2:-1])
        return f"decoder.flow_net.{idx}.{inner}.{_conv_leaf(path[-1])}", is_kernel
    if net == "mobile_decoder":
        idx = _decoder_index(net, path[0])
        inner = ".".join(path[1:-1])
        return f"mobile_net.{idx}.{inner}.{_conv_leaf(path[-1])}", is_kernel
    raise KeyError(f"{net}: no port parameter for {coll}/{'/'.join(path)}")


def state_dict_from_flax(net: str, variables: Mapping) -> dict[str, torch.Tensor]:
    """Convert ``net``'s Flax variables ({'params': …, 'batch_stats': …} of
    numpy arrays) into the port's state dict, transposing conv kernels from
    HWIO to OIHW.

    Args:
        net: one of ``"flownet"``, ``"posenet"``, ``"mobile_decoder"``.
    """
    if net not in NETS:
        raise ValueError(f"net must be one of {NETS}, not {net!r}")
    sd: dict[str, torch.Tensor] = {}
    for (coll, *path), value in _flatten(variables).items():
        key, is_kernel = torch_key(net, coll, tuple(path))
        arr = np.asarray(value, dtype=np.float32)
        if is_kernel and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO → OIHW
        sd[key] = torch.from_numpy(np.array(arr, order="C"))  # a copy: device_get arrays are read-only
    return sd


def _find(state: Any, fields: tuple[str, ...]) -> Any:
    """The first node of an optax state (a nest of named tuples, tuples,
    lists and dicts) that has every attribute of ``fields``."""
    if all(hasattr(state, k) for k in fields):
        return state
    children = state.values() if isinstance(state, Mapping) else state if isinstance(state, (tuple, list)) else ()
    for c in children:
        found = _find(c, fields)
        if found is not None:
            return found
    return None


def adam_state_from_optax(opt_state: Any, param_names: list[str] | Mapping[str, list[str]]) -> dict:
    """Carry optax's Adam state into the port's ``training.Adam``.

    ``opt_state``: the JAX package's optimizer state (``clip_by_global_norm``
    → ``adam``, wrapped in ``apply_if_finite`` with
    ``skip_nonfinite_updates``), pulled to numpy (``jax.device_get``); its
    ``ScaleByAdamState`` holds ``count`` and the moments ``mu``/``nu`` as
    Flax trees under the trained nets' names, as the JAX train state keeps
    them. ``param_names``: {net: its ``named_parameters`` names, in order},
    in the optimizer's net order (``training.trainable_param_names``), or
    the mobile decoder's names alone. Returns the state dict
    ``Adam.load_state_dict`` reads (the ``torch.optim.Adam`` layout: per
    parameter ``step``, ``exp_avg``, ``exp_avg_sq``, numbered over the nets
    in that order), with conv kernels transposed HWIO → OIHW, and
    ``apply_if_finite``'s ``notfinite_count``, ``last_finite`` and
    ``total_notfinite`` in the param group when the state has them."""
    if not isinstance(param_names, Mapping):
        param_names = {"mobile_decoder": list(param_names)}
    adam = _find(opt_state, ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("no optax ScaleByAdamState (count, mu, nu) found in opt_state")
    count = int(np.asarray(adam.count))
    moments: dict[str, list[torch.Tensor]] = {"mu": [], "nu": []}
    for which in ("mu", "nu"):
        tree = getattr(adam, which)
        for net, names in param_names.items():
            sub = tree[net] if net in tree else tree if len(param_names) == 1 else None
            if sub is None:
                raise KeyError(f"optax {which} holds no {net!r} (it holds {sorted(tree)})")
            # the moments have the params' tree, so they map as the params do
            sd = state_dict_from_flax(net, {"params": sub})
            if set(sd) != set(names):
                raise KeyError(f"optax {which} of {net} holds {sorted(set(sd) ^ set(names))} unlike the parameters")
            moments[which] += [sd[n] for n in names]
    state = {
        i: {"step": torch.tensor(float(count)), "exp_avg": mu, "exp_avg_sq": nu}
        for i, (mu, nu) in enumerate(zip(moments["mu"], moments["nu"]))
    }
    group: dict = {"params": list(range(len(state)))}
    finite = _find(opt_state, ("notfinite_count", "last_finite", "total_notfinite"))
    if finite is not None:
        group.update(notfinite_count=int(np.asarray(finite.notfinite_count)),
                     last_finite=bool(np.asarray(finite.last_finite)),
                     total_notfinite=int(np.asarray(finite.total_notfinite)))
    return {"state": state, "param_groups": [group]}


# ------------------------------------------------------------- Mask R-CNN

_D2_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _d2_key(path: tuple) -> tuple[str, str]:
    """Flax path (without the collection) of the JAX ``MaskRCNN`` → (the
    detectron2 key, kind ∈ {conv, convT, fc, plain}): the inverse of
    ``mdn_sfm_tpu.masks.maskrcnn.torch_d2_key_to_flax``."""
    top, leaf = path[0], path[-1]
    if top == "bottom_up":
        name = path[1]
        if name in ("stem_conv1", "stem_bn1"):
            block = "backbone.bottom_up.stem.conv1"
        else:
            m = re.fullmatch(r"(res\d)_(\d+)", name)
            if m is None:
                raise KeyError(path)
            sub = path[2]
            layer = "shortcut" if sub.startswith("downsample") else f"conv{sub[-1]}"
            block = f"backbone.bottom_up.{m.group(1)}.{m.group(2)}.{layer}"
            name = sub
        if name.endswith("conv") or name.startswith("conv") or name == "stem_conv1":
            return f"{block}.weight", "conv"
        return f"{block}.norm.{_D2_BN_LEAF[leaf]}", "plain"
    torch_leaf = "weight" if leaf == "kernel" else "bias"
    name = path[1]
    if top == "fpn":
        prefix = "backbone"
    elif top == "rpn_head":
        prefix = "proposal_generator.rpn_head"
    elif top == "box_head":
        prefix = "roi_heads.box_head" if name in ("fc1", "fc2") else "roi_heads.box_predictor"
    elif top == "mask_head":
        prefix = "roi_heads.mask_head"
    else:
        raise KeyError(path)
    if leaf != "kernel":
        kind = "plain"
    elif top == "box_head":
        kind = "fc"
    else:
        kind = "convT" if name == "deconv" else "conv"
    return f"{prefix}.{name}.{torch_leaf}", kind


def maskrcnn_state_dict_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """A JAX ``MaskRCNN``'s variables ({'params': …, 'batch_stats': …} of
    numpy arrays) → the detectron2-keyed state dict the port's ``MaskRCNN``
    loads with ``load_state_dict(strict=True)``: conv kernels HWIO → OIHW,
    the deconv's kernel spatially flipped and → (in, out, kh, kw), dense
    kernels transposed."""
    sd: dict[str, torch.Tensor] = {}
    for (_coll, *path), value in _flatten(variables).items():
        key, kind = _d2_key(tuple(path))
        arr = np.asarray(value, dtype=np.float32)
        if kind == "conv":
            arr = arr.transpose(3, 2, 0, 1)
        elif kind == "convT":
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        elif kind == "fc":
            arr = arr.T
        sd[key] = torch.from_numpy(np.array(arr, order="C"))
    return sd
