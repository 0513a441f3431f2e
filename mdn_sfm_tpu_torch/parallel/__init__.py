"""Data parallelism over processes, one device each — the port's
counterpart of :mod:`mdn_sfm_tpu.parallel`.

The JAX package runs one process per host over a global ``Mesh('data')``
and a ``shard_map`` step whose only collectives are explicit ``pmean``s.
Here each process drives one device (``cuda:LOCAL_RANK``, or the CPU), and
the train step makes one explicit all-reduce a step through
``torch.distributed``: NCCL on the card, gloo on the CPU.
"""

from .data_parallel import all_reduce_mean, group_rank_and_size, local_rows
from .distributed import (barrier, current_group, init_distributed, maybe_initialize_distributed, process_count,
                          process_device, process_index, shutdown_distributed)

__all__ = [
    "all_reduce_mean",
    "barrier",
    "current_group",
    "group_rank_and_size",
    "init_distributed",
    "local_rows",
    "maybe_initialize_distributed",
    "process_count",
    "process_device",
    "process_index",
    "shutdown_distributed",
]
