"""Comparisons shared by the nuScenes family's parity tests
(tests/test_torch_mask2former.py, test_torch_bbox3d.py,
test_torch_bevformer_det.py).

Tolerances are the port's: ``close`` bounds the error by ``tol`` x
max|ref|; ``grads_close`` holds every gradient leaf within 2% of the leaf
with an atol floor of 1e-4 x the global gradient scale
(tests/test_grad_parity.py).
"""

from __future__ import annotations

import numpy as np
import torch

from stereoscene_torch.utils.weights import _flatten, rules_trees


def as_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def close(got, want, tol: float, msg: str = "") -> None:
    want = as_numpy(want)
    got = as_numpy(got)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6),
                               err_msg=msg)


def grads_close(got, want) -> None:
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys()
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert scale > 1e-3
    bad = []
    for key, w in want.items():
        w, g = np.asarray(w), np.asarray(got[key])
        leaf = max(np.abs(w).max(), np.abs(g).max(), 1e-6)
        err = np.abs(g - w).max()
        if err > max(2e-2 * leaf, 1e-4 * scale):
            bad.append((key, float(err / leaf)))
    assert not bad, bad[:8]


def port_grads(module, rules):
    """The gradients of ``module``'s parameters as a flax tree."""
    grads = {n: p.grad for n, p in module.named_parameters()
             if p.grad is not None}
    return rules_trees(module, rules, grads)[0]


def distinct_tree(template, seed: int = 0):
    """A tree of ``template``'s shapes whose leaves are all distinct: a
    permutation of 1..N over every element of every leaf, scaled down."""
    shapes = {k: tuple(v.shape) for k, v in _flatten(template).items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    values = (np.random.RandomState(seed).permutation(total) + 1.0) / total
    out, offset = {}, 0
    for path, shape in shapes.items():
        n = int(np.prod(shape))
        out[path] = values[offset:offset + n].astype(np.float32).reshape(
            shape)
        offset += n
    return out
