"""Spatial sharding of the voxel grid, port of
``stereoscene_tpu/parallel/spatial.py``.

The JAX package constrains the voxel features after the view transform to
a ``('data', 'space')`` sharding and lets GSPMD partition the 3D encoder,
inserting the convolutions' halo exchanges and their transposes. The port
writes them by hand. Over the space group of S ranks (``mesh.init_space``)
each rank holds an X slab of every voxel tensor, channels-first
[B, C, X, Y, Z]:

- ``shard_voxels`` cuts this rank's slab from a whole grid: the image side
  and the splat run whole on every space rank (GSPMD replicates them), so
  an image-side parameter's gradient on a rank is the part that reaches
  its slab;
- ``halo`` adds the neighbours' boundary planes along X, differentiably:
  zeros at the grid's ends for a convolution's zero padding, or the edge
  plane repeated for a resize's clamped edge. Its backward sends each halo
  plane's gradient back to its owner, which adds it to that plane;
- ``models.layers.Conv3d`` and ``GroupNorm`` built with ``sharded=True``
  (the 3D encoder, its neck and the head) exchange halos and pool their
  statistics over the space group where it has more than one rank;
- ``gather_slabs`` joins the slabs of a tensor on every space rank,
  differentiably: the eval's logits, and the branches that read the whole
  grid (CRP3D, OHEM's threshold).

The exchange runs point to point (``batch_isend_irecv``) under NCCL and
for CPU tensors under gloo. gloo's send and recv take CPU tensors only, so
for CUDA tensors under gloo (ranks sharing one card) the planes go
through an ``all_reduce`` of the space group instead, which gloo runs on
CUDA tensors: each rank writes its outgoing planes into its own row of a
zero fp32 buffer of S rows and reads its neighbours' rows of the sum.
``HALO_STATS`` counts the exchanges and the bytes each rank sends, and
the bytes of the gathered tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from . import mesh

# halo exchanges and the bytes this rank sent in them; bytes of the tensors
# gather_slabs built (the all_reduce's payload)
HALO_STATS = {"exchanges": 0, "bytes": 0, "gathered": 0}


def active() -> bool:
    """True where the voxel grid is sharded over more than one rank."""
    return mesh.space_size() > 1


def check_grid(x_size: int, total_stride: int) -> None:
    """Raise, by name, where an X of ``x_size`` voxels cannot be sharded
    over the space group: each slab must hold a whole number of voxels at
    every stride of the 3D encoder."""
    s = mesh.space_size()
    if x_size % (s * total_stride):
        raise ValueError(
            f"spatial sharding: grid X = {x_size} is not a multiple of "
            f"{s} space shards x the 3D encoder's total stride "
            f"{total_stride}")


def shard_voxels(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """This rank's slab of ``x`` along ``dim`` (the grid's X axis: dim 2 of
    [B, C, X, Y, Z] features, dim 1 of [B, X, Y, Z] labels); ``x`` itself
    unsharded."""
    s = mesh.space_size()
    if s == 1:
        return x
    if x.shape[dim] % s:
        raise ValueError(f"spatial sharding: dim {dim} of {tuple(x.shape)} "
                         f"does not divide into {s} slabs")
    n = x.shape[dim] // s
    return x.narrow(dim, mesh.space_rank() * n, n)


def _p2p(t: torch.Tensor) -> bool:
    return t.device.type == "cpu" or dist.get_backend(
        mesh.space_group()) == "nccl"


def _swap(to_lower: torch.Tensor, to_upper: torch.Tensor
          ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Send ``to_lower`` to the space rank below and ``to_upper`` to the
    one above; returns (what the rank below sent up, what the rank above
    sent down), None past the grid's ends. Every rank sends the same
    shapes."""
    s, n = mesh.space_rank(), mesh.space_size()
    group = mesh.space_group()
    to_lower = to_lower.contiguous()
    to_upper = to_upper.contiguous()
    HALO_STATS["exchanges"] += 1
    HALO_STATS["bytes"] += (int(s > 0) * to_lower.numel()
                            * to_lower.element_size()
                            + int(s < n - 1) * to_upper.numel()
                            * to_upper.element_size())
    if _p2p(to_lower):
        peers = mesh.group_ranks(group)
        from_lower = torch.empty_like(to_upper) if s > 0 else None
        from_upper = torch.empty_like(to_lower) if s < n - 1 else None
        ops = []
        if s > 0:
            if to_lower.numel():
                ops.append(dist.P2POp(dist.isend, to_lower, peers[s - 1],
                                      group=group))
            if from_lower.numel():
                ops.append(dist.P2POp(dist.irecv, from_lower, peers[s - 1],
                                      group=group))
        if s < n - 1:
            if to_upper.numel():
                ops.append(dist.P2POp(dist.isend, to_upper, peers[s + 1],
                                      group=group))
            if from_upper.numel():
                ops.append(dist.P2POp(dist.irecv, from_upper, peers[s + 1],
                                      group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_lower, from_upper
    # an fp32 buffer whatever the planes' dtype: adding zeros is exact
    a = to_lower.numel()
    buf = to_lower.new_zeros((n, a + to_upper.numel()), dtype=torch.float32)
    buf[s, :a] = to_lower.reshape(-1)
    buf[s, a:] = to_upper.reshape(-1)
    dist.all_reduce(buf, group=group)
    dtype = to_lower.dtype
    from_lower = (buf[s - 1, a:].view(to_upper.shape).to(dtype)
                  if s > 0 else None)
    from_upper = (buf[s + 1, :a].view(to_lower.shape).to(dtype)
                  if s < n - 1 else None)
    return from_lower, from_upper


class _Halo(torch.autograd.Function):
    """[lower neighbour's last ``lo`` planes, x, upper neighbour's first
    ``hi`` planes] along ``dim``, zeros past the grid's ends."""

    @staticmethod
    def forward(ctx, x, dim, lo, hi):
        ctx.dim, ctx.lo, ctx.hi = dim, lo, hi
        size = x.shape[dim]
        from_lower, from_upper = _swap(x.narrow(dim, 0, hi),
                                       x.narrow(dim, size - lo, lo))

        def planes(t, k):
            if t is not None:
                return t
            shape = list(x.shape)
            shape[dim] = k
            return x.new_zeros(shape)

        return torch.cat([planes(from_lower, lo), x, planes(from_upper, hi)],
                         dim)

    @staticmethod
    def backward(ctx, grad):
        dim, lo, hi = ctx.dim, ctx.lo, ctx.hi
        size = grad.shape[dim] - lo - hi
        g_lo = grad.narrow(dim, 0, lo)
        g_hi = grad.narrow(dim, lo + size, hi)
        gx = grad.narrow(dim, lo, size).clone(
            memory_format=torch.contiguous_format)
        from_lower, from_upper = _swap(g_lo, g_hi)
        if from_lower is not None and hi:
            gx.narrow(dim, 0, hi).add_(from_lower)
        if from_upper is not None and lo:
            gx.narrow(dim, size - lo, lo).add_(from_upper)
        return gx, None, None, None


def halo(x: torch.Tensor, lo: int, hi: int, dim: int = 2,
         edge: str = "zeros") -> torch.Tensor:
    """``x`` (this rank's slab) with ``lo`` planes of the rank below and
    ``hi`` of the rank above concatenated along ``dim``, differentiably.
    Past the grid's ends the planes are zeros (``edge="zeros"``, a
    convolution's zero padding) or the edge plane repeated
    (``edge="replicate"``, a resize's clamped edge). Every rank of the
    space group must call it with the same shapes, in the same order."""
    if lo > x.shape[dim] or hi > x.shape[dim]:
        raise ValueError(f"spatial sharding: a halo of ({lo}, {hi}) planes "
                         f"is wider than a slab of {x.shape[dim]}")
    out = _Halo.apply(x, dim, lo, hi)
    if edge == "zeros":
        return out
    if edge != "replicate":
        raise ValueError(f"unknown halo edge {edge!r}")
    s, n = mesh.space_rank(), mesh.space_size()
    size = x.shape[dim]
    parts = [out.narrow(dim, lo, size)]
    if lo:
        parts.insert(0, (x.narrow(dim, 0, 1).expand(
            *[lo if d == dim % x.dim() else -1 for d in range(x.dim())])
            if s == 0 else out.narrow(dim, 0, lo)))
    if hi:
        parts.append(x.narrow(dim, size - 1, 1).expand(
            *[hi if d == dim % x.dim() else -1 for d in range(x.dim())])
            if s == n - 1 else out.narrow(dim, lo + size, hi))
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    """The slabs joined along ``dim``: an ``all_reduce`` of the whole
    tensor with zeros outside this rank's slab (exact, and run by gloo on
    CUDA tensors too). Backward, its transpose: this rank's slab of the
    sum over the space group of the whole gradients. Each rank's objective
    is the global loss (``mesh.reduce_gradients``), and a region that every
    space rank computes whole from the gathered tensor sends back on each
    rank only what its own part of that objective needs (its slab of the
    output, its replicated terms pooled over the data group), so the sum
    adds each part once."""

    @staticmethod
    def forward(ctx, x, dim):
        n, s = mesh.space_size(), mesh.space_rank()
        size = x.shape[dim]
        ctx.dim, ctx.start, ctx.size = dim, s * size, size
        shape = list(x.shape)
        shape[dim] = n * size
        full = x.new_zeros(shape)
        full.narrow(dim, s * size, size).copy_(x)
        dist.all_reduce(full, group=mesh.space_group())
        HALO_STATS["gathered"] += full.numel() * full.element_size()
        return full

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=mesh.space_group())
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None


def gather_slabs(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The space group's slabs of ``x`` joined along ``dim`` in slab order,
    on every space rank, differentiably (``_Gather``); ``x`` itself
    unsharded. The eval gathers its logits with it, CRP3D its stage
    (``models/resnet3d.py``), OHEM its detached losses."""
    if mesh.space_size() == 1:
        return x
    return _Gather.apply(x, dim)
