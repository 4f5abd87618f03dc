"""Data parallelism over a ``torch.distributed`` process group: the port's
counterpart of ``stereoscene_tpu/parallel/mesh.py`` for its ``data`` axis
(the reference's DDP over NCCL, ref occupancy/apis/mmdet_train.py:75-79).

The JAX package jits one train step over the global batch sharded on the
mesh's ``data`` axis, so its losses, BatchNorm statistics and random masks
are those of the global batch and XLA adds the gradient all-reduce. The
port runs one process (rank) per device and computes the same numbers by
hand:

- ``all_sum`` pools a tensor over the ranks with the matching backward: the
  loss terms' numerators and denominators (``losses/``) and BatchNorm's
  statistics (``models.layers.BatchNorm``);
- ``reduce_gradients`` averages the gradient list (``engine.train``): with
  the losses pooled, each rank's ``autograd.grad`` returns W times its
  share of the global loss's gradient;
- DropPath and dropout masks are drawn for the global batch and each rank
  keeps its rows (``models.layers.keep_mask``).

Every rank holds the same batch size. Without an initialised group every
helper is the single-process identity, so one process runs as before.
"""

from __future__ import annotations

import datetime
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device_type: str = "cuda", backend=None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, rendezvous at ``coordinator`` (``host:port``, the JAX
    CLI's flag, or a ``tcp://`` / ``file://`` URL); returns this rank's
    device (``rank_device``), made current on CUDA. The backend is NCCL on
    ``cuda`` and gloo on ``cpu``; ``backend`` overrides it (two ranks
    sharing one card need gloo: NCCL refuses them). Collectives that wait
    longer than ``timeout_s`` raise."""
    device = rank_device(device_type, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


def rank_device(device_type: str, process_id: int = 0) -> torch.device:
    """The device of rank ``process_id``: ``cuda:process_id % cards`` on
    ``cuda``, the CPU on ``cpu``."""
    if device_type == "cuda":
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return torch.device(device_type)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """Rank 0, the one that writes logs and checkpoints."""
    return rank() == 0


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if initialized():
        dist.destroy_process_group()


def barrier() -> None:
    if initialized():
        dist.barrier()


def _collective_device() -> torch.device:
    """Where the group's small host-side collectives run: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_ints(values: Sequence[int], op: str = "sum") -> List[int]:
    """``values`` reduced elementwise over the ranks by ``op`` (``sum``,
    ``min`` or ``max``), as Python ints on every rank."""
    if not initialized():
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=_collective_device())
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    dist.all_reduce(t, op=ops[op])
    return [int(v) for v in t.tolist()]


class _AllSum(torch.autograd.Function):
    """Forward: the sum over the ranks. Backward: the sum over the ranks of
    the incoming gradients, since every rank's copy of the sum feeds its
    own part of the loss."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiably; ``t`` itself without a
    group."""
    return _AllSum.apply(t) if initialized() else t


class _AllGather(torch.autograd.Function):
    """Forward: the ranks' tensors concatenated along dim 0, in rank order
    (every rank holds the same shape). Backward: this rank's rows of the
    sum over the ranks of the incoming gradients, since every rank's copy
    feeds its own part of the loss."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        ctx.rows = x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        r = dist.get_rank()
        return grad[r * ctx.rows:(r + 1) * ctx.rows]


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in rank order,
    differentiably (a loss that sorts over the global batch, Lovasz);
    ``t`` itself without a group."""
    return _AllGather.apply(t) if initialized() else t


def _flat_apply(tensors: Sequence[torch.Tensor],
                fn: Callable[[torch.Tensor], None]) -> List[torch.Tensor]:
    """Apply the in-place collective ``fn`` to ``tensors`` through one flat
    buffer per (dtype, device); returns the results as views of those
    buffers, in order and in the tensors' shapes."""
    out: List[torch.Tensor] = [None] * len(tensors)
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        fn(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def sum_tensors(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks, without a gradient, through one
    flat buffer per dtype; ``tensors`` unchanged without a group."""
    if not initialized():
        return list(tensors)
    return _flat_apply(tensors, dist.all_reduce)


def reduce_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each gradient, all-reduced through one
    flat buffer per dtype; ``grads`` unchanged without a group. Every rank
    gets the same bits, so parameters stay equal across ranks."""
    if not initialized():
        return list(grads)
    w = world_size()

    def mean_(flat):
        dist.all_reduce(flat)
        flat.div_(w)

    return _flat_apply(grads, mean_)


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Copy rank 0's parameters and buffers into every rank's ``module``,
    in place."""
    if not initialized():
        return
    tensors = list(module.state_dict(keep_vars=True).values())
    for t, new in zip(tensors, _flat_apply(
            tensors, lambda flat: dist.broadcast(flat, src=0))):
        t.copy_(new)
