"""The data-parallel step's pieces — the role of ``mdn_sfm_tpu/parallel/mesh.py``
in a world of one process a device.

Nothing is broadcast: as on the JAX mesh, every rank builds identical
params from the same seed, or loads the same checkpoint files, and the
step's one all-reduce keeps them identical. The spatial mesh of the JAX
package has no counterpart: one card runs the whole image.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils import divisor

Tensor = torch.Tensor


def group_rank_and_size(group) -> tuple[int, int]:
    """(rank, size) in ``group``; (0, 1) for None (no group)."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_rows(x: Tensor, rank: int, world: int) -> Tensor:
    """Rank ``rank``'s rows of the global batch ``x``: the ``rank``-th of
    ``world`` equal blocks of its leading axis, as ``shard_map`` lays a
    batch out over the data axis."""
    b = x.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} does not split into {world} equal shards")
    n = b // world
    return x[rank * n:(rank + 1) * n]


def all_reduce_mean(tensors: list[Tensor], group) -> list[Tensor]:
    """The mean of ``tensors`` over the group's ranks, in ONE all-reduce of
    their flat float32 concatenation: a sum, then a division by the group's
    size (gloo has no mean; the division is by a tensor, as ``utils.divisor``
    says why). Returns new tensors of the inputs' shapes and dtypes; on a
    group of one rank they equal the inputs bit for bit."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat = flat / divisor(flat, float(dist.get_world_size(group)))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out
