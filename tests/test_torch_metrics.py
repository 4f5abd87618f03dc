"""The port's SSC metrics against ``stereoscene_tpu.metrics``: the same
seeded batches (with 255 ignore labels) through both ``update_state``s,
then ``compute`` / ``evaluate_dict``. Counts are equal, scores within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu import metrics as jmetrics
from stereoscene_tpu.losses import KITTI_CLASS_NAMES as JAX_NAMES
from stereoscene_torch import metrics

SHAPE = (2, 16, 16, 4)


def _batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        target = rng.randint(0, 20, SHAPE)
        target = np.where(rng.rand(*SHAPE) < 0.6, 0, target)
        target = np.where(rng.rand(*SHAPE) < 0.1, 255, target)
        pred = np.where(rng.rand(*SHAPE) < 0.5, target % 255,
                        rng.randint(0, 20, SHAPE))
        out.append((pred.astype(np.int64), target.astype(np.int32)))
    return out


def _states(batches):
    js, ts = jmetrics.empty_state(), metrics.empty_state()
    for pred, target in batches:
        js = jmetrics.update_state(js, jnp.asarray(pred),
                                   jnp.asarray(target))
        ts = metrics.update_state(ts, torch.from_numpy(pred),
                                  torch.from_numpy(target))
    return js, ts


def test_class_names_match_jax():
    assert metrics.KITTI_CLASS_NAMES == list(JAX_NAMES)


def test_counts_and_scores_match_jax():
    js, ts = _states(_batches())
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].dtype == torch.int64
        np.testing.assert_array_equal(ts[k].numpy(),
                                      np.asarray(js[k]).astype(np.int64))
    jscores, tscores = jmetrics.compute(js), metrics.compute(ts)
    for k in jscores:
        np.testing.assert_allclose(tscores[k].numpy(), np.asarray(jscores[k]),
                                   rtol=0, atol=1e-6)
    jd = jmetrics.evaluate_dict(js, JAX_NAMES)
    td = metrics.evaluate_dict(ts)
    assert td.keys() == jd.keys()
    for k in jd:
        assert abs(td[k] - jd[k]) <= 1e-6, k


def test_ignored_voxels_change_nothing():
    """Voxels labelled 255 do not count, whatever is predicted there."""
    (pred, target), = _batches(1, seed=1)
    a = metrics.update_state(metrics.empty_state(), torch.from_numpy(pred),
                             torch.from_numpy(target))
    other = np.where(target == 255, (pred + 7) % 20, pred)
    b = metrics.update_state(metrics.empty_state(), torch.from_numpy(other),
                             torch.from_numpy(target))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_reduce_state_host_is_the_sum_of_shards():
    batches = _batches(4, seed=2)
    _, whole = _states(batches)
    shards = [_states(batches[i::2])[1] for i in range(2)]
    summed = metrics.reduce_state_host(shards)
    jsum = jmetrics.reduce_state_host([_states(batches[i::2])[0]
                                       for i in range(2)])
    for k in whole:
        assert torch.equal(summed[k], whole[k]), k
        np.testing.assert_array_equal(summed[k].numpy(),
                                      np.asarray(jsum[k]).astype(np.int64))


@pytest.mark.parametrize("n_voxels", [2**24 + 3])
def test_counts_stay_exact_past_float32(n_voxels):
    """int64 counts stay exact where float32 counts (the JAX state) stop
    counting: 2**24 + 3 voxels of one class."""
    state = metrics.empty_state()
    ones = torch.ones(n_voxels, dtype=torch.int64)
    state = metrics.update_state(state, ones, ones)
    assert int(state["tps"][1]) == n_voxels
    assert int(state["completion_tp"]) == n_voxels
    assert float(np.float32(2**24) + np.float32(1)) == 2**24
