"""The port's optional losses against the JAX package's on the same numpy
inputs: values within 1e-5 relative (fp32 reductions in another order),
input gradients within 1e-5 of their scale, except Lovasz's, whose sort
makes the gradient depend on how equal errors are ordered: its inputs are
continuous random probabilities (no ties) and its gradient is held within
2%. The streaming evaluation of the ce / sem_scal / geo_scal triple is
held against the full upsample (the port's and the JAX package's) within
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.losses import extras as jext
from stereoscene_tpu.losses import lovasz as jlov
from stereoscene_tpu.losses import semkitti as jsem
from stereoscene_tpu.losses import streaming as jstream
from stereoscene_torch.engine import train as ttrain
from stereoscene_torch.losses import extras as text
from stereoscene_torch.losses import lovasz as tlov
from stereoscene_torch.losses import semkitti as tsem
from stereoscene_torch.losses import streaming as tstream
from stereoscene_torch.ops.resize import resize_trilinear

DBOUND = (2.0, 10.0, 0.5)
CW = tsem.class_weights_from_frequencies()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU at once, and a full torch thread pool in each makes
    the CPU's bf16 and conv kernels crawl (oversubscription)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _voxels(seed, shape=(2, 8, 8, 4), classes=20, ignore=0.1):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(*shape, classes) * 2).astype(np.float32)
    target = np.where(rng.rand(*shape) < ignore, 255,
                      rng.randint(0, classes, shape)).astype(np.int32)
    return logits, target


def _value_and_grad(fn, x):
    t = torch.from_numpy(np.array(x)).requires_grad_()
    value = fn(t)
    (grad,) = torch.autograd.grad(value, t)
    return float(value.detach()), grad.numpy()


def _jax_value_and_grad(fn, x):
    value, grad = jax.value_and_grad(fn)(jnp.asarray(x))
    return float(value), np.asarray(grad)


def _check(got, want, rtol=1e-5, grad_tol=1e-5):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol, atol=1e-7)
    scale = np.abs(want[1]).max()
    assert scale > 0
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=grad_tol * scale)


@pytest.mark.parametrize("top_k", [0.25, 0.6])
@pytest.mark.parametrize("ignore", [0.1, 0.9])
def test_ohem_matches_jax(top_k, ignore):
    logits, target = _voxels(1, ignore=ignore)
    _check(_value_and_grad(lambda x: tsem.ohem_ce_ssc_loss(
               x, torch.from_numpy(target), CW, top_k), logits),
           _jax_value_and_grad(lambda x: jsem.ohem_ce_ssc_loss(
               x, jnp.asarray(target), CW, top_k), logits))


def test_kl_sep_matches_jax():
    rng = np.random.RandomState(2)
    p = rng.rand(6, 20).astype(np.float32)
    t = np.where(rng.rand(6, 20) < 0.3, 0, rng.rand(6, 20)).astype(
        np.float32)
    _check(_value_and_grad(lambda x: tsem.kl_sep(x, torch.from_numpy(t)), p),
           _jax_value_and_grad(lambda x: jsem.kl_sep(x, jnp.asarray(t)), p))


@pytest.mark.parametrize("ignore", [255, 0, None])
@pytest.mark.parametrize("classes", ["present", "all"])
def test_lovasz_matches_jax(ignore, classes):
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 40, 20).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    labels = rng.randint(0, 12, (3, 40))
    labels[rng.rand(3, 40) < 0.2] = 255 if ignore == 255 else 0
    want = _jax_value_and_grad(lambda p: jlov.lovasz_softmax(
        p, jnp.asarray(labels), ignore=ignore, classes=classes), probs)
    got = _value_and_grad(lambda p: tlov.lovasz_softmax(
        p, torch.from_numpy(labels), ignore=ignore, classes=classes), probs)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    scale = np.abs(want[1]).max()
    np.testing.assert_allclose(got[1], want[1], rtol=2e-2,
                               atol=1e-5 * scale)


def test_dice_and_position_aware_losses_match_jax():
    logits, target = _voxels(4)
    occ = np.asarray(jax.nn.sigmoid(logits[..., 0]))
    _check(_value_and_grad(lambda p: text.soft_dice_loss(
               p, torch.from_numpy(target)), occ),
           _jax_value_and_grad(lambda p: jext.soft_dice_loss(
               p, jnp.asarray(target)), occ))
    np.testing.assert_array_equal(
        text.local_geometric_anisotropy(torch.from_numpy(target)).numpy(),
        np.asarray(jext.local_geometric_anisotropy(jnp.asarray(target))))
    _check(_value_and_grad(lambda x: text.position_aware_loss(
               x, torch.from_numpy(target), CW), logits),
           _jax_value_and_grad(lambda x: jext.position_aware_loss(
               x, jnp.asarray(target), CW), logits))


def test_frustum_proportion_loss_matches_jax():
    logits, _ = _voxels(5)
    rng = np.random.RandomState(5)
    masks = rng.rand(2, 4, 8, 8, 4) < 0.3
    masks[:, 3] = False  # an empty frustum is skipped
    dists = rng.randint(0, 30, (2, 4, 20)).astype(np.float32)
    dists[..., 5] = 0
    _check(_value_and_grad(lambda x: text.frustum_proportion_loss(
               x, torch.from_numpy(masks), torch.from_numpy(dists)), logits),
           _jax_value_and_grad(lambda x: jext.frustum_proportion_loss(
               x, jnp.asarray(masks), jnp.asarray(dists)), logits))


def test_gaussian_target_and_klv_depth_loss_match_jax():
    rng = np.random.RandomState(6)
    depth = ((rng.rand(2, 1, 32, 64) < 0.3)
             * rng.uniform(1.0, 12.0, (2, 1, 32, 64))).astype(np.float32)
    got = text.gaussian_depth_target(torch.from_numpy(depth), 4, DBOUND, 16)
    want = jext.gaussian_depth_target(jnp.asarray(depth), 4, DBOUND, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    logits = rng.randn(2, 8, 16, 16).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(logits, -1))
    _check(_value_and_grad(lambda p: text.klv_depth_loss(
               torch.from_numpy(depth), p, 4, DBOUND), probs),
           _jax_value_and_grad(lambda p: jext.klv_depth_loss(
               jnp.asarray(depth), p, 4, DBOUND), probs))


@pytest.mark.parametrize("factor,chunks", [(1, 4), (2, 4), (2, 1), (4, 2)])
def test_streaming_matches_the_full_upsample(factor, chunks):
    """Against the port's full upsample at every factor, and against the
    JAX package's streaming losses where it takes the factor (1x, 2x)."""
    logits, _ = _voxels(7, shape=(2, 4, 8, 2))
    _, target = _voxels(8, shape=(2, 4 * factor, 8 * factor, 2 * factor))
    gt = torch.from_numpy(target)

    def stream(x):
        return tstream.streaming_voxel_losses(x, gt, CW, chunks)

    def full(x):
        up = resize_trilinear(x, tuple(gt.shape[1:]))
        return {"ce": tsem.ce_ssc_loss(up, gt, CW),
                "sem_scal": tsem.sem_scal_loss(up, gt),
                "geo_scal": tsem.geo_scal_loss(up, gt)}

    for name in ("ce", "sem_scal", "geo_scal"):
        got = _value_and_grad(lambda x: stream(x)[name], logits)
        _check(got, _value_and_grad(lambda x: full(x)[name], logits))
        if factor <= 2:
            _check(got, _jax_value_and_grad(
                lambda x: jstream.streaming_voxel_losses(
                    x, jnp.asarray(target), CW, chunks)[name], logits))


def test_streaming_refuses_what_it_does_not_cover():
    cfg = ttrain.LossConfig(stream_voxel_chunks=2, voxel_ohem=1.0)
    logits, target = _voxels(9)
    with pytest.raises(ValueError, match="stream_voxel_chunks"):
        ttrain.compute_losses({"output_voxels": torch.from_numpy(logits)},
                              {"gt_occ": torch.from_numpy(target)}, cfg)
    with pytest.raises(ValueError, match="divisible"):
        tstream.streaming_voxel_losses(torch.from_numpy(logits),
                                       torch.from_numpy(target), CW, 3)
