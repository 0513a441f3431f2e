"""Checkpoints in the reference layout — the port of
``mdn_sfm_tpu.checkpoints``.

    {log_dir}/{version}/models/opt.json
    {log_dir}/{version}/models/weights_{idx}/{flownet,posenet,mobile_decoder,adam}.pth
    {log_dir}/{version}/models/weights_{idx}/meta.json

The port's native format is the reference's own: each net's ``state_dict``
(the port's modules carry the reference's parameter names), and Adam's
state in ``torch.optim.Adam``'s ``state_dict`` layout. So the reference repo
loads these files, and the JAX package reads the nets through its ``.pth``
route (``mdn_sfm_tpu.checkpoints.load_checkpoint``). A folder holds the nets
being trained: the mobile decoder, and flow and pose (with their BN
statistics) when ``fine_tune_flow_motion``. ``adam.pth`` numbers the
parameters in ``training.trainable_nets``' order (the decoder's, then
flow's and pose's), and with ``skip_nonfinite_updates`` its param group
also holds ``notfinite_count``, ``last_finite`` and ``total_notfinite``.

Every file is written to a temporary name and moved into place with
``os.replace``. ``meta.json`` (``step``, ``base_step``) is written last: it
marks the folder complete. A folder the port is writing also holds the
marker :data:`IN_PROGRESS` until ``meta.json`` is in place, so a save cut
short never counts for ``--resume auto``, while a reference folder (which
has neither file) still does. Loads take the key intersection by name and
shape; every other entry keeps its current value.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import torch
from torch import nn

NETS = ("flownet", "posenet", "mobile_decoder")
IN_PROGRESS = "saving.incomplete"


def weights_folder(log_dir: str, version: str, idx: int) -> str:
    return os.path.join(log_dir, version, "models", f"weights_{idx}")


def _complete(folder: str) -> bool:
    """A port checkpoint with its ``meta.json``, or a reference folder (no
    in-progress marker) with its mobile decoder."""
    if not os.path.exists(os.path.join(folder, "mobile_decoder.pth")):
        return False
    if os.path.exists(os.path.join(folder, "meta.json")):
        return True
    return not os.path.exists(os.path.join(folder, IN_PROGRESS))


def latest_weights_idx(log_dir: str, version: str) -> int | None:
    """Highest complete ``weights_{idx}`` under ``log_dir/version/models``,
    or None (used by ``--resume auto``)."""
    models_dir = os.path.join(log_dir, version, "models")
    if not os.path.isdir(models_dir):
        return None
    best = None
    for name in os.listdir(models_dir):
        if not name.startswith("weights_"):
            continue
        try:
            idx = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if _complete(os.path.join(models_dir, name)):
            best = idx if best is None else max(best, idx)
    return best


def merge_partial(target: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]) -> dict:
    """Key-intersection partial load: an entry of ``target`` takes
    ``loaded``'s value where the name exists there with the same shape, and
    keeps its own otherwise; entries only in ``loaded`` are dropped."""
    merged = {}
    for k, v in target.items():
        cand = loaded.get(k)
        ok = isinstance(cand, torch.Tensor) and tuple(cand.shape) == tuple(v.shape)
        merged[k] = cand if ok else v
    return merged


def to_host(tree):
    """A CPU copy of every tensor in a nest of dicts/lists (never a view of
    the live tensors, which the optimizer updates in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(
    folder: str,
    state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
    adam_state: dict | None = None,
    step: int = 0,
    base_step: int = 0,
) -> None:
    """Write ``{name}.pth`` for each net of ``state_dicts``, ``adam.pth``
    and, last, ``meta.json``. Pass CPU copies (:func:`to_host`) when the
    write runs beside training.

    ``base_step``: the step counter at the start of the run that wrote this
    checkpoint. The counter carries over between fine-tune stages, so
    ``step - base_step`` is this run's progress; ``--resume auto`` re-enters
    the (epoch, batch) position from it."""
    os.makedirs(folder, exist_ok=True)
    marker = os.path.join(folder, IN_PROGRESS)
    with open(marker, "w"):
        pass
    meta = os.path.join(folder, "meta.json")
    if os.path.exists(meta):  # overwriting: incomplete until the new meta lands
        os.remove(meta)
    for name, sd in state_dicts.items():
        _atomic_save(dict(sd), os.path.join(folder, f"{name}.pth"))
    if adam_state is not None:
        _atomic_save(adam_state, os.path.join(folder, "adam.pth"))
    with open(meta + ".tmp", "w") as f:
        json.dump({"step": int(step), "base_step": int(base_step)}, f)
    os.replace(meta + ".tmp", meta)
    os.remove(marker)


def read_meta(folder: str) -> dict:
    """The folder's ``meta.json`` ({} for a reference folder)."""
    meta = os.path.join(folder, "meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f)
    return {}


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(
    folder: str,
    state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
    models_to_load: tuple[str, ...] = NETS,
    load_adam: bool = False,
) -> tuple[dict, dict | None, int]:
    """Read the nets ``models_to_load`` from ``folder``, each merged into
    its entry of ``state_dicts`` by :func:`merge_partial`.

    Returns (state dicts, the Adam state of ``adam.pth`` when ``load_adam``
    and the file exists, else None, step). Raises FileNotFoundError for a
    missing net, with the conversion to use when the folder holds the JAX
    package's ``.msgpack`` files."""
    out = dict(state_dicts)
    for name in models_to_load:
        pth = os.path.join(folder, f"{name}.pth")
        if not os.path.exists(pth):
            if os.path.exists(os.path.join(folder, f"{name}.msgpack")):
                raise FileNotFoundError(
                    f"{folder} holds the JAX package's {name}.msgpack but no {name}.pth. Convert it: "
                    "torch.save(mdn_sfm_tpu_torch.weights.state_dict_from_flax(name, variables[name]), "
                    "path_pth) after mdn_sfm_tpu.checkpoints.load_checkpoint (the README's block)"
                )
            raise FileNotFoundError(f"no checkpoint for {name} in {folder}")
        out[name] = merge_partial(state_dicts[name], _load(pth))
    adam = os.path.join(folder, "adam.pth")
    adam_state = _load(adam) if load_adam and os.path.exists(adam) else None
    return out, adam_state, int(read_meta(folder).get("step", 0))


def load_into(folder: str, modules: Mapping[str, nn.Module], names: tuple[str, ...]) -> int:
    """Load the nets ``names`` from ``folder`` into ``modules`` ({name:
    module}) by :func:`load_checkpoint`'s key intersection; returns the
    checkpoint's step."""
    merged, _, step = load_checkpoint(folder, {n: modules[n].state_dict() for n in names}, names)
    for n in names:
        modules[n].load_state_dict(merged[n])
    return step
