"""Process-group set-up — the counterpart of ``mdn_sfm_tpu/parallel/distributed.py``.

Two launch contracts, as the JAX package reads them:

* the package's own: ``MDN_COORDINATOR`` (``host:port`` of rank 0),
  ``MDN_NUM_PROCESSES`` and ``MDN_PROCESS_ID``, one process a device
  (``LOCAL_RANK`` picks the card on a host with several; default 0);
* torchrun's, in place of the TPU pod's discovery: ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``. NCCL
without CUDA raises; nothing falls back to gloo on the card.
"""

from __future__ import annotations

import os
import torch
import torch.distributed as dist

from ..utils import resolve_device
from .data_parallel import group_rank_and_size


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_device(device: str | torch.device | None = None) -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for ``cuda`` (the
    default), else ``device`` as given. Raises without CUDA unless the CPU
    is asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank())
    return dev


def init_distributed(device: str | torch.device | None, world_size: int, rank: int, init_method: str) -> torch.device:
    """Join a process group of ``world_size`` ranks as ``rank`` through
    ``init_method`` (``tcp://host:port``, ``file://path`` or ``env://``):
    NCCL bound to this process's card for a ``cuda`` device, gloo for the
    CPU. Returns the process's device."""
    dev = process_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a cuda process group needs NCCL, which this PyTorch build lacks")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world_size, rank=rank, device_id=dev)
    elif dev.type == "cpu":
        dist.init_process_group("gloo", init_method=init_method, world_size=world_size, rank=rank)
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    return dev


def maybe_initialize_distributed(device: str | torch.device | None = None) -> bool:
    """Join the process group the environment describes (``MDN_*``, else
    torchrun's variables) on ``device`` (``cuda`` unless asked otherwise).
    Returns True when a group of more than one process is set up; with one
    process, or none described, nothing is set up and it returns False."""
    env = os.environ
    coordinator = env.get("MDN_COORDINATOR")
    num_processes = int(env.get("MDN_NUM_PROCESSES", "0"))
    process_id = int(env.get("MDN_PROCESS_ID", "-1"))
    if coordinator and num_processes > 1 and process_id >= 0:
        init_distributed(device, num_processes, process_id, f"tcp://{coordinator}")
        return True
    world = int(env.get("WORLD_SIZE", "1"))
    if world > 1 and "RANK" in env:
        init_distributed(device, world, int(env["RANK"]), "env://")
        return True
    return False


def current_group():
    """The default process group, or None when this process joined none."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return group_rank_and_size(current_group())[0]


def process_count() -> int:
    """The group's size (1 without a group)."""
    return group_rank_and_size(current_group())[1]


def barrier() -> None:
    """Every process of the group meets here before any goes on (no-op
    without a group)."""
    if process_count() > 1:
        dist.barrier()


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if current_group() is not None:
        dist.destroy_process_group()
