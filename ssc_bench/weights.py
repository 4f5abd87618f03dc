"""Seeded weights for both sides of the comparison, made on the device.

One ``torch.rand`` call on a generator of the device fills a flat buffer
for every tensor of the model's ``state_dict``; each tensor is then a view
of that buffer mapped to its distribution: He-uniform convolution and
linear weights, small biases, norm scales near 1, BatchNorm statistics
near (0, 1), the zero-initialised gates (``gamma``, ``alpha``) at 0.3 so
the branches behind them count, and the DCN offset head at a tenth of its
He bound (sub-pixel offsets).

The names a family damps (``DAMPED``) start at ``DAMPING`` of their
scale: the family module says why.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]
DAMPING = 0.3


def spec_of(state_dict: Dict[str, torch.Tensor]) -> Spec:
    """The (name, shape) of every floating-point tensor."""
    return [(k, tuple(v.shape)) for k, v in state_dict.items()
            if v.is_floating_point()]


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``stream``), so
    weights, frames and masks draw from separate streams of one seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63 - 1))
    return gen


@torch.no_grad()
def make(spec: Spec, seed: int, device,
         damped: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """float32 tensors by name, views of one buffer drawn from ``seed``;
    those whose names end in one of ``damped`` at ``DAMPING`` of their
    scale."""
    total = sum(math.prod(s) for _, s in spec)
    flat = torch.rand(total, generator=generator(seed, device, 0),
                      device=device)
    out, at = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        sym = u.mul_(2.0).sub_(1.0)  # uniform in [-1, 1)
        if name.endswith("running_mean"):
            sym.mul_(0.35)
        elif name.endswith("running_var"):
            sym.mul_(0.25).add_(1.0)
        elif name.endswith((".gamma", ".alpha")):
            sym.fill_(0.3)
        elif len(shape) >= 2:
            bound = math.sqrt(6.0 / math.prod(shape[1:]))
            if "conv_offset" in name:
                bound *= 0.1
            sym.mul_(bound)
        elif name.endswith(".weight"):  # a norm's scale
            sym.mul_(0.17).add_(1.0)
        else:  # a bias
            sym.mul_(0.17)
        if name.endswith(tuple(damped)):
            sym.mul_(DAMPING)
        out[name] = u
    return out
