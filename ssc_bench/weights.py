"""Seeded weights for both sides of the comparison, made on the device.

One ``torch.rand`` call on a generator of the device fills a flat buffer
for every tensor of the model's ``state_dict``; each tensor is then a view
of that buffer mapped to its distribution: He-uniform convolution and
linear weights, small biases, norm scales near 1, BatchNorm statistics
near (0, 1), the zero-initialised gates (``gamma``, ``alpha``) at 0.3 so
the branches behind them count, and the DCN offset head at a tenth of its
He bound (sub-pixel offsets).

The image backbone's residual branches enter at 0.3 of their scale (the
scale and shift of each MBConv block's last BatchNorm), as EfficientNet's
training starts them near zero. With every branch at full scale the 55
blocks of b7 are chaotic under random weights: the activations grow to
1e6 and bfloat16 rounding grows with them until the image features
differ from float32 by most of their size, so no comparison could tell a
sound bfloat16 run from a broken one. For the same reason the three
convolutions that feed a softmax over the 112 depth bins start at 0.3 of
their scale: at full scale some seeds gave the MIE's fused depth
distribution a mean peak of 0.58 with nearly tied bins, where bfloat16
rounding moves a pixel's depth and with it the voxel features it lifts
(the fused distribution 5.7% off float32 where the inputs were 1.3% off),
so a sound run read as far from the reference as float8 does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...]]]
# the last norm of each MBConv residual branch, and the three convolutions
# whose outputs a softmax over the depth bins turns into a distribution
# (DepthNet's depth head, the stereo volume's head, the MIE's last conv)
DAMPED = ("linear_conv.bn.weight", "linear_conv.bn.bias",
          "depth_net.depth_conv.5.weight", "depth_net.depth_conv.5.bias",
          "classif3_2.0.weight", "volume_interaction.redir2.weight",
          "volume_interaction.redir2.bias")
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
def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors by name, views of one buffer drawn from ``seed``."""
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
        if name.endswith(DAMPED):
            sym.mul_(DAMPING)
        out[name] = u
    return out
