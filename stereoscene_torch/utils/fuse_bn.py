"""Fold BatchNorm into the preceding convolution for inference, port of
``stereoscene_tpu/utils/fuse_bn.py`` (the reference's
``tools/misc/fuse_conv_bn.py``).

For every conv -> BN pair of a module named ``conv`` and a ``BatchNorm``
named ``bn`` side by side (EfficientNet's ``ConvBNAct``, VoVNet's
``ConvBN``: the pairs the JAX package's ``_find_conv_bn_pairs`` finds), the
conv's output channels are rescaled by f = gamma / sqrt(var + eps) and the
BN becomes the identity affine that adds the folded bias: weight 1, bias
beta - f * mean, mean 0, var 1 - eps, so that eval mode computes

    y = (W * x - 0) / sqrt(1 - eps + eps) * 1 + (beta - f * mean)
      = f * W * x + beta - f * mean.

It works on the port's ``state_dict``: the module tree and key layout do
not change, only the numbers. Each BN's own ``eps`` is taken (1e-3 in
``ConvBNAct``, 1e-5 in VoVNet's ``ConvBN``); the JAX function applies one
``eps`` (1e-3) to every pair.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn as nn

from ..models.layers import BatchNorm


def conv_bn_pairs(model: nn.Module) -> Iterator[Tuple[str, float]]:
    """(module name, BN eps) of every module holding a conv child ``conv``
    and a ``BatchNorm`` child ``bn``; the name is the prefix of their keys
    (``<name>.conv.weight``, ``<name>.bn.*``)."""
    for name, module in model.named_modules():
        children = dict(module.named_children())
        conv, bn = children.get("conv"), children.get("bn")
        if isinstance(conv, nn.modules.conv._ConvNd) and isinstance(
                bn, BatchNorm):
            yield name, float(bn.eps)


def fuse_conv_bn(model: nn.Module,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], int]:
    """-> (the fused copy of ``state_dict``, by default the model's own,
    and the number of pairs folded). ``model`` names the pairs and their
    eps; the arithmetic is float64, each result cast back to its key's
    dtype."""
    sd = {k: v.detach().clone() for k, v in (
        model.state_dict() if state_dict is None else state_dict).items()}
    count = 0
    for name, eps in conv_bn_pairs(model):
        p = f"{name}." if name else ""
        w_key, bn = f"{p}conv.weight", f"{p}bn."
        gamma = sd[bn + "weight"].double()
        beta = sd[bn + "bias"].double()
        mean = sd[bn + "running_mean"].double()
        var = sd[bn + "running_var"].double()
        factor = gamma / torch.sqrt(var + eps)
        w = sd[w_key]
        shape = (-1,) + (1,) * (w.dim() - 1)
        sd[w_key] = (w.double() * factor.reshape(shape)).to(w.dtype)
        bias = sd[bn + "bias"]
        sd[bn + "weight"] = torch.ones_like(sd[bn + "weight"])
        sd[bn + "bias"] = (beta - factor * mean).to(bias.dtype)
        sd[bn + "running_mean"] = torch.zeros_like(sd[bn + "running_mean"])
        sd[bn + "running_var"] = torch.full_like(sd[bn + "running_var"],
                                                 1.0 - eps)
        count += 1
    return sd, count
