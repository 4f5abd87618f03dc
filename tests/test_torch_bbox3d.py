"""The port's 3D box core (``stereoscene_torch/core/bbox3d.py``) against
the JAX package's: box normalisation both ways, the pairwise L1 cost, the
Hungarian assigner, ``batched_nms`` (random boxes, tied scores, the
``max_out`` cut) and ``decode_nms_free`` (random and tied scores).

Tolerances: fp32 values within 1e-6 of their scale; masks, labels and
assignments equal. Discrete steps are held with margins: no random box
pair's IoU lies within 1e-3 of the NMS threshold, the assignment is
unchanged under a perturbation of 1e-4 of the cost's scale, and ties are
exact (equal scores), where both packages keep the lower index first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.core import bbox3d as jb
from stereoscene_torch.core import bbox3d as tb
from stereoscene_torch.models.mask2former_occ import hungarian_match
from torch_parity import close


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, velocity=True):
    parts = [rng.uniform(-50, 50, (n, 3)), rng.uniform(0.5, 10, (n, 3)),
             rng.uniform(-np.pi, np.pi, (n, 1))]
    if velocity:
        parts.append(rng.uniform(-5, 5, (n, 2)))
    return np.concatenate(parts, axis=1).astype(np.float32)


@pytest.mark.parametrize("velocity", [True, False])
def test_normalize_denormalize_match_jax(velocity):
    boxes = _boxes(np.random.RandomState(0), 7, velocity)
    boxes[0, 3] = 0.0  # a degenerate size takes the 1e-6 floor
    want = jb.normalize_bbox(jnp.asarray(boxes))
    got = tb.normalize_bbox(_t(boxes))
    assert got.shape == (7, 10 if velocity else 8)
    close(got, want, 1e-6)
    close(tb.denormalize_bbox(got), jb.denormalize_bbox(want), 1e-6)
    close(tb.denormalize_bbox(got)[1:], boxes[1:], 1e-5)


def test_bbox3d_l1_cost_matches_jax():
    rng = np.random.RandomState(1)
    pred = rng.randn(2, 5, 10).astype(np.float32)
    tgt = rng.randn(2, 3, 10).astype(np.float32)
    close(tb.bbox3d_l1_cost(_t(pred), _t(tgt), 0.25),
          jb.bbox3d_l1_cost(jnp.asarray(pred), jnp.asarray(tgt), 0.25),
          1e-6)


def test_assigner_matches_jax():
    """Random costs, one padded target; the assignment holds under a
    perturbation of 1e-4 of the cost's scale."""
    rng = np.random.RandomState(2)
    b, q, t, c = 2, 9, 4, 5
    cls = (rng.randn(b, q, c) * 2).astype(np.float32)
    preds = rng.randn(b, q, 10).astype(np.float32)
    gt = rng.randn(b, t, 10).astype(np.float32)
    labels = rng.randint(0, c, (b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 2] = False
    want = np.asarray(jb.HungarianAssigner3D().assign(
        *(jnp.asarray(a) for a in (cls, preds, labels, gt, valid))))
    got = tb.HungarianAssigner3D().assign(
        *(_t(a) for a in (cls, preds, labels, gt, valid)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[1] == 2).sum() == 1  # the padded slot still takes a query
    logp = torch.log_softmax(_t(cls), -1)
    cost = (-torch.gather(logp, 2, _t(labels).long()[:, None].expand(b, q, t))
            + 0.25 * tb.bbox3d_l1_cost(_t(preds), _t(gt)))
    noise = torch.from_numpy(rng.randn(b, q, t).astype(np.float32))
    shaken = cost + 1e4 * (~_t(valid))[:, None] \
        + 1e-4 * cost.abs().max() * noise
    np.testing.assert_array_equal(hungarian_match(shaken).numpy(), want)


def _xyxy(rng, n):
    lo = rng.uniform(0, 40, (n, 2))
    return np.concatenate([lo, lo + rng.uniform(2, 12, (n, 2))],
                          1).astype(np.float32)


def _iou(b):
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lo = np.maximum(b[:, None, :2], b[None, :, :2])
    hi = np.minimum(b[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(hi - lo, 0, None), -1)
    return inter / (area[:, None] + area[None] - inter)


@pytest.mark.parametrize("max_out", [100, 12])
def test_batched_nms_matches_jax(max_out):
    """60 random boxes in 3 classes: many suppressions, some across
    classes that must not happen; ``max_out`` 12 cuts the kept list."""
    rng = np.random.RandomState(3)
    boxes = _xyxy(rng, 60)
    scores = rng.rand(60).astype(np.float32)
    labels = rng.randint(0, 3, 60).astype(np.int32)
    assert np.abs(_iou(boxes) - 0.3).min() > 1e-3
    want = np.asarray(jb.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(labels), 0.3, max_out))
    got = tb.batched_nms(_t(boxes), _t(scores), _t(labels), 0.3, max_out)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() <= min(max_out, 59)
    if max_out == 12:
        assert want.sum() == 12


def test_batched_nms_tied_scores():
    """Equal scores: the stable order keeps the lower index, which then
    suppresses its overlapping twin, on both sides."""
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [1, 1, 11, 11],
                      [50, 50, 60, 60], [0, 0, 10, 10], [51, 51, 61, 61]],
                     np.float32)
    scores = np.array([0.5, 0.9, 0.9, 0.5, 0.5, 0.5], np.float32)
    labels = np.array([0, 0, 0, 1, 0, 1], np.int32)
    want = np.asarray(jb.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(labels), 0.5))
    got = tb.batched_nms(_t(boxes), _t(scores), _t(labels), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [False, True, False, True, False,
                                         False])


@pytest.mark.parametrize("tied", [False, True])
def test_decode_nms_free_matches_jax(tied):
    """Random class logits, or logits taking three values so that most
    (query, class) scores tie; boxes partly outside the range."""
    rng = np.random.RandomState(4 + tied)
    b, q, c = 2, 20, 4
    if tied:
        cls = rng.choice([-1.0, 0.5, 2.0], (b, q, c)).astype(np.float32)
    else:
        cls = rng.randn(b, q, c).astype(np.float32)
    boxes = tb.normalize_bbox(_t(_boxes(rng, b * q))).numpy().reshape(
        b, q, 10)
    boxes[:, ::3, :2] *= 2  # some centres beyond 61.2 m
    kw = dict(max_num=15, score_threshold=0.3,
              post_center_range=(-61.2, -61.2, -10, 61.2, 61.2, 10))
    want = jb.decode_nms_free(jnp.asarray(cls), jnp.asarray(boxes), **kw)
    got = tb.decode_nms_free(_t(cls), _t(boxes), **kw)
    assert got.keys() == want.keys()
    for key in ("labels", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    close(got["scores"], want["scores"], 1e-6)
    close(got["boxes"], want["boxes"], 1e-6)
    assert got["boxes"].shape == (b, 15, 9)
    valid = got["valid"].numpy()
    assert valid.any() and not valid.all()
