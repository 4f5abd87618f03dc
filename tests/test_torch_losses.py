"""The port's losses against the JAX package's, on the same numpy inputs:
values within 1e-5 relative (fp32 reductions in another order), and the
all-ignore batch (label 255 everywhere), which is finite on both sides: 0
for CE, sem_scal and the depth loss, 3 * -log(1e-12) for geo_scal (its
clamped ratios are 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.losses import depth as jdepth
from stereoscene_tpu.losses import semkitti as jsem
from stereoscene_torch.losses import depth as tdepth
from stereoscene_torch.losses import semkitti as tsem

DBOUND = (2.0, 10.0, 0.5)


def _voxels(seed, ignore=0.1, shape=(2, 8, 8, 4), classes=20):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, classes) * 2).astype(np.float32)
    target = np.where(rng.rand(*shape) < ignore, 255,
                      rng.randint(0, classes, shape)).astype(np.int32)
    return logits, target


def test_class_weights():
    np.testing.assert_array_equal(tsem.class_weights_from_frequencies(),
                                  jsem.class_weights_from_frequencies())


@pytest.mark.parametrize("name", ["ce_ssc_loss", "sem_scal_loss",
                                  "geo_scal_loss"])
@pytest.mark.parametrize("ignore", [0.1, 1.0])
def test_voxel_losses(name, ignore):
    logits, target = _voxels(0, ignore)
    extra = ((jsem.class_weights_from_frequencies(),)
             if name == "ce_ssc_loss" else ())
    want = float(getattr(jsem, name)(jnp.asarray(logits),
                                     jnp.asarray(target), *extra))
    got = getattr(tsem, name)(torch.from_numpy(logits),
                              torch.from_numpy(target), *extra)
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)
    if ignore == 1.0 and name != "geo_scal_loss":
        assert float(got) == 0.0


def test_sem_scal_class_filling_every_voxel():
    """One class everywhere: its specificity term is skipped."""
    logits, _ = _voxels(1)
    target = np.full(logits.shape[:-1], 3, np.int32)
    want = float(jsem.sem_scal_loss(jnp.asarray(logits), jnp.asarray(target)))
    got = tsem.sem_scal_loss(torch.from_numpy(logits),
                             torch.from_numpy(target))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def _depth(seed, hits):
    rng = np.random.RandomState(seed)
    gt = ((rng.rand(2, 1, 32, 64) < hits)
          * (rng.rand(2, 1, 32, 64) * 9.0 + 1.5)).astype(np.float32)
    probs = rng.rand(2, 4, 8, 16).astype(np.float32)
    return gt, probs / probs.sum(-1, keepdims=True)


def test_downsample_gt_depth():
    gt, _ = _depth(2, 0.1)
    want = np.asarray(jdepth.downsample_gt_depth(jnp.asarray(gt), 8, DBOUND,
                                                 16))
    got = tdepth.downsample_gt_depth(torch.from_numpy(gt), 8, DBOUND, 16)
    assert 0 < want.sum() < want.shape[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hits", [0.1, 0.0])
def test_bce_depth_loss(hits):
    gt, probs = _depth(3, hits)
    probs = np.concatenate([probs] * 4, -1)  # D = 16
    probs /= probs.sum(-1, keepdims=True)
    want = float(jdepth.bce_depth_loss(jnp.asarray(gt), jnp.asarray(probs),
                                       8, DBOUND))
    got = tdepth.bce_depth_loss(torch.from_numpy(gt),
                                torch.from_numpy(probs), 8, DBOUND)
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)
    if hits == 0.0:
        assert float(got) == 0.0


def test_losses_are_differentiable():
    logits, target = _voxels(4)
    lg = torch.from_numpy(logits).requires_grad_()
    t = torch.from_numpy(target)
    total = (tsem.ce_ssc_loss(lg, t, tsem.class_weights_from_frequencies())
             + tsem.sem_scal_loss(lg, t) + tsem.geo_scal_loss(lg, t))
    total.backward()
    assert torch.isfinite(lg.grad).all() and lg.grad.abs().max() > 0
