"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel/``, its ``data`` axis)."""

from .mesh import (
    all_gather_rows,
    all_sum,
    barrier,
    broadcast_module,
    init_distributed,
    initialized,
    is_primary,
    rank,
    rank_device,
    reduce_gradients,
    reduce_ints,
    shutdown,
    sum_tensors,
    world_size,
)

__all__ = [
    "all_gather_rows",
    "all_sum",
    "barrier",
    "broadcast_module",
    "init_distributed",
    "initialized",
    "is_primary",
    "rank",
    "rank_device",
    "reduce_gradients",
    "reduce_ints",
    "shutdown",
    "sum_tensors",
    "world_size",
]
