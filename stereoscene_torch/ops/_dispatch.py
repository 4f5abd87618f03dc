"""The one rule every kernel wrapper follows to pick its route."""

from __future__ import annotations

import torch


def want_kernel(name: str, use_kernel, *tensors: torch.Tensor,
                differentiable: bool = False) -> bool:
    """True when ``name`` must launch its CUDA kernel.

    ``use_kernel`` None means "the kernel when the tensors are on CUDA".
    A CUDA tensor with ``use_kernel`` not False takes the kernel (which
    launches or raises); a CPU tensor takes the plain version and may not
    ask for the kernel. A wrapper whose kernel has no backward
    (``differentiable`` False) raises when asked for the kernel with an
    input that requires grad under grad mode."""
    # plain loops, not generators: this runs on every kernel call's host
    # path
    cuda = tensors[0].is_cuda
    for t in tensors:
        if t.is_cuda != cuda:
            raise ValueError(f"{name}: inputs are on different devices")
    if use_kernel is False:
        return False
    if not cuda:
        if use_kernel:
            raise ValueError(
                f"{name}: use_kernel=True needs CUDA tensors, got "
                f"{tensors[0].device}")
        return False
    if not differentiable and torch.is_grad_enabled():
        for t in tensors:
            if t.requires_grad:
                raise NotImplementedError(
                    f"{name}: the CUDA kernel is forward-only; run under "
                    f"torch.no_grad() or pass use_kernel=False")
    return True
