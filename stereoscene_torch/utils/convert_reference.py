"""Bring a reference ``state_dict`` into a port model, port of the checks
of ``stereoscene_tpu/utils/convert_reference.py``.

The port's modules carry the reference's ``state_dict`` keys and torch
layouts, so a reference checkpoint needs no name map or layout transform:
``load_reference`` holds it to the model's own keys and shapes, with the
JAX converter's checks (tests/test_convert_reference.py):

- an unexpected key raises, naming it with the closest model key as a
  hint; BN ``num_batches_tracked`` counters and checkpoint bookkeeping
  (``meta``, ``optimizer``) are tolerated, on either side;
- a missing key raises, naming it; a shape mismatch raises;
- the key errors are ``RuntimeError``s worded as ``load_state_dict``'s
  ("Missing key(s)", "Unexpected key(s)");
- half-precision values are cast to the model's dtype;
- a checkpoint saved after the reference's ``fuse_conv_bn`` (each BN's
  keys gone, its conv carrying a new ``.bias``) is adapted first
  (``adapt_fused_state_dict``).

``strict=False`` loads what matches and reports the rest.
"""

from __future__ import annotations

import difflib
import re
from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

# entries that carry no weights: BN step counters and mmcv bookkeeping
NOISE_KEY = re.compile(
    r"(^|\.)num_batches_tracked$|^(meta|optimizer)($|\.)")


def as_tensors(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` with numpy values (or numpy scalars) as tensors."""
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
            for k, v in state_dict.items()}


def adapt_fused_state_dict(
        state_dict: Mapping[str, torch.Tensor],
        targets: Mapping[str, Tuple[int, ...]],
        eps_for: Callable[[str], float]) -> Dict[str, torch.Tensor]:
    """A copy of ``state_dict`` (saved after the reference's
    ``fuse_conv_bn``) with every fused-away BN the model expects
    (``targets``: the model's keys and shapes) rebuilt as the identity
    affine that carries its conv's fused bias: weight 1, that bias, mean 0,
    var 1 - ``eps_for(bn module)``. The conv keeps its fused weight and
    loses the bias, so the model computes what the fused reference did.

    The fused conv is found as the JAX converter finds it: an unclaimed
    ``.bias`` whose ``.weight`` the model has and whose own key it lacks,
    under the BN's parent module, as wide as the BN; preferring an
    index-matched sibling (``bn1`` <-> ``conv1``, Sequential ``.1`` <->
    ``.0``), then the longest common prefix. Two candidates that tie raise
    rather than guess."""
    sd = dict(state_dict)
    loose = [k for k in sd if k.endswith(".bias") and k not in targets
             and f"{k[:-5]}.weight" in targets]
    for key in sorted(targets):
        if not key.endswith(".running_mean") or key in sd:
            continue
        bn_module = key[:-len(".running_mean")]
        parent, bn_comp = (bn_module.rsplit(".", 1) if "." in bn_module
                           else ("", bn_module))
        parent = parent + "." if parent else ""
        bn_digit = re.search(r"(\d+)$", bn_comp)
        width = targets[key][0]
        best, best_score, tied = None, (-1, -1), None
        for cand in loose:
            if cand not in sd or not cand.startswith(parent):
                continue  # claimed by an earlier BN, or another module's
            if sd[cand].shape[0] != width:
                continue  # a fused conv's bias is as wide as its BN
            comp = cand[:-len(".bias")][len(parent):].split(".", 1)[0]
            digit = re.search(r"(\d+)$", comp)
            if bn_comp.isdigit() and comp.isdigit():
                idx_match = int(comp) == int(bn_comp) - 1
            elif bn_digit and digit:
                idx_match = digit.group(1) == bn_digit.group(1)
            else:
                idx_match = False
            lcp = 0
            for a, b in zip(bn_module, cand):
                if a != b:
                    break
                lcp += 1
            score = (int(idx_match), lcp)
            if score > best_score:
                best, best_score, tied = cand, score, None
            elif score == best_score:
                tied = cand
        if best is None:
            continue  # left missing: load_reference names it
        if tied is not None:
            raise ValueError(
                f"fused-BN adaptation is ambiguous for {bn_module}: "
                f"candidate conv biases {best!r} and {tied!r} tie on "
                f"(index-match, common-prefix) score {best_score}; rename "
                f"or pre-assign one of them in the state_dict")
        bias = sd.pop(best).float()
        eps = eps_for(bn_module)
        sd[f"{bn_module}.weight"] = torch.ones(width)
        sd[f"{bn_module}.bias"] = bias
        sd[f"{bn_module}.running_mean"] = torch.zeros(width)
        sd[f"{bn_module}.running_var"] = torch.full((width,), 1.0 - eps)
    return sd


def load_reference(model: nn.Module, state_dict: Mapping,
                   strict: bool = True) -> Tuple[List[str], List[str]]:
    """Load ``state_dict`` into ``model``, each value cast to the dtype of
    the model's entry; -> (the model's keys it lacks, its keys the model
    has not), noise aside. Raises under ``strict`` on a missing or
    unexpected key and always on a shape mismatch, before loading
    anything."""
    own = model.state_dict()
    targets = {k: tuple(v.shape) for k, v in own.items()}
    modules = dict(model.named_modules())
    sd = adapt_fused_state_dict(as_tensors(state_dict), targets,
                                lambda name: float(modules[name].eps))
    out, missing = {}, []
    for key, want in own.items():
        if key not in sd:
            if not NOISE_KEY.search(key):
                missing.append(key)
            continue
        value = sd[key]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)} "
                             f"!= the model's {tuple(want.shape)}")
        out[key] = value.to(want.dtype)
    unexpected = sorted(k for k in sd if k not in own
                        and not NOISE_KEY.search(k))
    if strict and unexpected:
        lines = []
        for k in unexpected[:10]:
            close = difflib.get_close_matches(k, list(own), n=1)
            hint = f"  (closest model key: {close[0]})" if close else ""
            lines.append(f"  {k}{hint}")
        raise RuntimeError(
            f"Unexpected key(s) in state_dict: {len(unexpected)} keys not "
            f"in the model (first 10 below); a checkpoint saved after "
            f"fuse_conv_bn is adapted where its fused convs can be "
            f"matched.\n" + "\n".join(lines))
    if strict and missing:
        raise RuntimeError(
            f"Missing key(s) in state_dict: {len(missing)} keys of the "
            f"model absent from the checkpoint, first 10: {missing[:10]}")
    model.load_state_dict(out, strict=False)
    return missing, unexpected
