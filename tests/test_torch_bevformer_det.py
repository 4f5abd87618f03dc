"""The port's BEVFormer detector against the JAX package's at TINY:
``inverse_sigmoid``, the focal loss, the decoder layer (nonzero sampling
offsets), the head with and without box refinement (forward, gradients,
and the detached reference points), the whole detector with can_bus and a
history BEV (forward, the loss of every decoder layer and its gradients,
the decoded boxes), ``obtain_history_bev`` with scene resets and no
gradient, ``PrevFrameInfo``, the loss on its own, and the weights carried
both ways with and without the can_bus MLP.

Weights come from ``seeded_init_`` (sampling offsets nonzero) and cross as
flax trees (``module_rules`` / ``flax_trees``). Tolerances: fp32 modules
within 1e-5 of their output's scale, 1e-4 after a softmax or a norm; the
whole detector within 2e-3 of max|ref|, loss terms rtol 2e-3; gradient
leaves within 2% with an atol floor of 1e-4 x the global gradient scale;
the host state (``PrevFrameInfo``) bitwise. Every Hungarian assignment
compared is unchanged under a perturbation of 1e-4 of its cost's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.core.bbox3d import normalize_bbox as jnormalize
from stereoscene_tpu.models import bevformer_det as jd
from stereoscene_torch.models import bevformer_det as td
from stereoscene_torch.models.mask2former_occ import hungarian_match
from stereoscene_torch.utils.weights import (
    _flatten,
    flax_template,
    flax_trees,
    load_flax_params,
    module_rules,
    rules_trees,
    seeded_init_,
)
from torch_parity import close, distinct_tree, grads_close, port_grads

PC = (-10.0, -10.0, -2.0, 10.0, 10.0, 2.0)
DET = dict(num_classes=3, num_query=12, embed_dim=32, bev_shape=(8, 8),
           num_encoder_layers=1, num_decoder_layers=2, pc_range=PC)
SHAPES = [(3, 4)]
IMG = (60, 100)
C_IN = 16


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


def _inputs(rng, b=1, t=None):
    """Image features and two forward pinhole cameras (ego x forward,
    one turned 30 degrees) on a 60x100 image."""
    lead = (b, t) if t else (b,)
    feats = rng.randn(*lead, 2, 12, C_IN).astype(np.float32)
    k = np.array([[40.0, 0, 50, 0], [0, 40, 30, 0], [0, 0, 1, 0]])
    ego2cam = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                        [0, 0, 0, 1]], np.float64)
    yaw = np.deg2rad(30)
    turn = np.eye(4)
    turn[:2, :2] = [[np.cos(yaw), np.sin(yaw)], [-np.sin(yaw), np.cos(yaw)]]
    l2i = np.stack([k @ ego2cam, k @ ego2cam @ turn]).astype(np.float32)
    return feats, np.broadcast_to(l2i, lead + l2i.shape).copy()


def _stable_assignment(cost):
    cost = np.asarray(cost, np.float32)
    assign = hungarian_match(_t(cost)).numpy()
    noise = np.random.RandomState(0).randn(*cost.shape).astype(np.float32)
    shaken = cost + 1e-4 * np.abs(cost[cost < 1e3]).max() * noise
    np.testing.assert_array_equal(hungarian_match(_t(shaken)).numpy(),
                                  assign)
    return assign


def test_inverse_sigmoid_and_focal_loss_match_jax():
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.rand(20), [0.0, 1.0, 1e-7]]).astype(np.float32)
    close(td.inverse_sigmoid(_t(x)), jd.inverse_sigmoid(jnp.asarray(x)),
          1e-5)
    logits = (rng.randn(4, 6, 5) * 3).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.randint(0, 5, (4, 6))]
    close(td.sigmoid_focal_loss(_t(logits), _t(onehot)),
          jd.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(onehot)),
          1e-5)


def test_decoder_layer_matches_jax():
    """Self-attention, deformable cross-attention into the BEV memory with
    nonzero offsets, FFN; gradients into the queries, the memory and every
    weight."""
    rng = np.random.RandomState(1)
    q, qp = (rng.randn(2, 7, 32).astype(np.float32) for _ in range(2))
    mem = rng.randn(2, 48, 32).astype(np.float32)
    ref = rng.rand(2, 7, 2).astype(np.float32)
    port = td.DetectionDecoderLayer(32, 8)
    seeded_init_(port, 1)
    assert port.cross_attn.sampling_offsets.weight.abs().min() > 0
    jmod = jd.DetectionDecoderLayer(32, 8)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), q, qp, mem,
                                         (6, 8), ref)["params"])
    params = rules_trees(port, rules)[0]
    cot = rng.randn(2, 7, 32).astype(np.float32)

    def jloss(p, x, m):
        out = jmod.apply({"params": p}, x, qp, m, (6, 8), ref)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(params, q, mem)
    x, m = _t(q).requires_grad_(), _t(mem).requires_grad_()
    got = port(x, _t(qp), m, (6, 8), _t(ref))
    close(got, want, 1e-4)
    (got * _t(cot)).sum().backward()
    close(x.grad, jgrads[1], 1e-4)
    close(m.grad, jgrads[2], 1e-4)
    grads_close(port_grads(port, rules), jgrads[0])


@pytest.mark.parametrize("refine", [True, False])
def test_head_matches_jax(refine):
    """Three decoder layers with per-layer branches (refining) or one
    shared set; forward and gradients. Refining, layers 1 and 2 sample
    around detached references, so the gradient into ``reference_points``
    comes from layer 0 alone; without refinement every layer's reference
    carries it."""
    rng = np.random.RandomState(2)
    kw = dict(num_classes=3, num_query=12, embed_dim=32,
              num_decoder_layers=3, pc_range=PC, with_box_refine=refine)
    bev = rng.randn(2, 48, 32).astype(np.float32)
    port = td.BEVFormerHead(**kw)
    seeded_init_(port, 2)
    jmod = jd.BEVFormerHead(**kw)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), bev,
                                         (6, 8))["params"])
    params = rules_trees(port, rules)[0]
    cots = [rng.randn(3, 2, 12, n).astype(np.float32) for n in (3, 10)]

    def jloss(p):
        out = jmod.apply({"params": p}, bev, (6, 8))
        return (jnp.sum(out["all_cls_scores"] * cots[0])
                + jnp.sum(out["all_bbox_preds"] * cots[1])), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    refs = []
    hooks = [getattr(port, f"layer{i}").register_forward_pre_hook(
        lambda mod, args: refs.append(args[-1])) for i in range(3)]
    got = port(_t(bev), (6, 8))
    for h in hooks:
        h.remove()
    assert got["all_bbox_preds"].shape == (3, 2, 12, 10)
    close(got["all_cls_scores"], want["all_cls_scores"], 1e-4)
    close(got["all_bbox_preds"], want["all_bbox_preds"], 1e-4)
    assert [r.requires_grad for r in refs] == [True, not refine, not refine]
    (sum((got[k] * _t(c)).sum() for k, c in
         zip(("all_cls_scores", "all_bbox_preds"), cots))).backward()
    grads_close(port_grads(port, rules), jgrads)
    cx = got["all_bbox_preds"][..., 0]
    assert (cx >= PC[0]).all() and (cx <= PC[3]).all()


def _gt(rng, b=1, t=4):
    boxes = np.concatenate([
        rng.uniform(-8, 8, (b, t, 2)), rng.uniform(-1.5, 1.5, (b, t, 1)),
        rng.uniform(0.5, 4, (b, t, 3)), rng.uniform(-np.pi, np.pi, (b, t, 1)),
        rng.uniform(-2, 2, (b, t, 2))], -1).astype(np.float32)
    labels = rng.randint(0, 3, (b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[0, -1] = False
    return boxes, labels, valid


def _loss_costs(out, boxes, labels, valid):
    """The assigner's cost of every decoder layer, as the loss builds it."""
    gt = np.asarray(jnormalize(jnp.asarray(boxes)))
    gt = np.concatenate([gt[..., 0:2], gt[..., 3:5], gt[..., 2:3],
                         gt[..., 5:]], -1)
    costs = []
    for cls, bbox in zip(np.asarray(out["all_cls_scores"]),
                         np.asarray(out["all_bbox_preds"])):
        logp = np.asarray(jax.nn.log_sigmoid(cls))
        cost = -np.take_along_axis(logp, np.broadcast_to(
            labels[:, None], (cls.shape[0], cls.shape[1], labels.shape[1])),
            2) + 0.25 * np.abs(bbox[:, :, None, :8]
                               - gt[:, None, :, :8]).sum(-1)
        costs.append(cost + 1e4 * (~valid)[:, None])
    return costs


def test_detection_loss_matches_jax():
    """The loss on its own: every layer's focal and L1 terms and their
    gradients into the outputs, a padded target slot included."""
    rng = np.random.RandomState(3)
    out = {"all_cls_scores": (rng.randn(2, 1, 12, 3) * 2).astype(np.float32),
           "all_bbox_preds": rng.randn(2, 1, 12, 10).astype(np.float32)}
    out["all_bbox_preds"][..., 0:2] *= 6
    boxes, labels, valid = _gt(rng)
    for cost in _loss_costs(out, boxes, labels, valid):
        _stable_assignment(cost)

    def jtotal(o):
        losses = jd.bevformer_detection_loss(o, boxes, labels, valid,
                                             num_classes=3)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        out)
    tout = {k: _t(v).requires_grad_() for k, v in out.items()}
    got = td.bevformer_detection_loss(tout, _t(boxes), _t(labels),
                                      _t(valid), num_classes=3)
    assert list(got) == ["loss_cls.d0", "loss_bbox.d0", "loss_cls",
                         "loss_bbox"]
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_allclose(float(value.detach()), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    sum(got.values()).backward()
    for key, value in tout.items():
        close(value.grad, jgrads[key], 1e-5, key)


def test_get_bboxes_matches_jax():
    rng = np.random.RandomState(4)
    out = {"all_cls_scores": rng.randn(2, 2, 12, 3).astype(np.float32),
           "all_bbox_preds": rng.randn(2, 2, 12, 10).astype(np.float32)}
    out["all_bbox_preds"][..., 0:2] *= 40
    want = jd.bevformer_get_bboxes({k: jnp.asarray(v) for k, v in
                                    out.items()}, max_num=9)
    got = td.bevformer_get_bboxes({k: _t(v) for k, v in out.items()},
                                  max_num=9)
    for key in ("labels", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    close(got["scores"], want["scores"], 1e-6)
    close(got["boxes"], want["boxes"], 1e-6)
    assert not got["valid"].all()


@pytest.fixture(scope="module")
def whole():
    """The port's and the JAX package's detector at TINY with can_bus, on
    the same weights: the history BEV of a 3-frame queue (a scene reset at
    frame 1), then the current frame against it: forward, the loss and its
    gradients."""
    rng = np.random.RandomState(5)
    feats, l2i = _inputs(rng)
    featsq, l2iq = _inputs(rng, t=3)
    can_bus = rng.randn(1, 18).astype(np.float32)
    can_bus[:, -1] = 20.0
    canq = rng.randn(1, 3, 18).astype(np.float32)
    exists = [False, False, True]
    boxes, labels, valid = _gt(rng)
    port = td.BEVFormerDetector(C_IN, can_bus=True, device="cpu", **DET)
    seeded_init_(port, 5)
    params, _ = flax_trees(port)
    jmod = jd.BEVFormerDetector(**DET)
    jhist = jd.obtain_history_bev(jmod, {"params": params}, featsq, SHAPES,
                                  l2iq, IMG, can_bus_queue=canq,
                                  prev_bev_exists=exists)

    def jloss(p):
        out = jmod.apply({"params": p}, feats, SHAPES, l2i, IMG,
                         prev_bev=jhist, can_bus=can_bus)
        losses = jd.bevformer_detection_loss(out, boxes, labels, valid,
                                             num_classes=3)
        return sum(losses.values()), (out, losses)

    (_, (jout, jlosses)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)

    tq = _t(featsq).requires_grad_()
    hist = td.obtain_history_bev(port, tq, SHAPES, _t(l2iq), IMG,
                                 can_bus_queue=_t(canq),
                                 prev_bev_exists=exists)
    out = port(_t(feats), SHAPES, _t(l2i), IMG, prev_bev=hist,
               can_bus=_t(can_bus))
    losses = td.bevformer_detection_loss(out, _t(boxes), _t(labels),
                                         _t(valid), num_classes=3)
    sum(losses.values()).backward()
    grads = flax_trees(port, {n: p.grad for n, p in port.named_parameters()
                              if p.grad is not None})[0]
    return dict(out=out, jout=jout, losses=losses, jlosses=jlosses,
                grads=grads, jgrads=jgrads, hist=hist, jhist=jhist, tq=tq,
                gt=(boxes, labels, valid), port=port, params=params,
                args=(feats, l2i, featsq, l2iq, can_bus, canq))


def test_detector_forward_matches_jax(whole):
    got, want = whole["out"], whole["jout"]
    assert got["all_cls_scores"].shape == (2, 1, 12, 3)
    assert got["bev_embed"].shape == (1, 64, 32)
    for key in ("all_cls_scores", "all_bbox_preds", "bev_embed"):
        close(got[key], want[key], 2e-3, key)


def test_history_bev_matches_jax_without_gradient(whole):
    """The history BEV matches JAX's, carries no gradient back to the
    queue, and the reset drops frame 0: the queue from frame 1 on gives
    the same BEV."""
    close(whole["hist"], whole["jhist"], 2e-3)
    assert not whole["hist"].requires_grad
    assert whole["tq"].grad is None
    _, _, featsq, l2iq, _, canq = whole["args"]
    again = td.obtain_history_bev(
        whole["port"], _t(featsq[:, 1:]), SHAPES, _t(l2iq[:, 1:]), IMG,
        can_bus_queue=_t(canq[:, 1:]), prev_bev_exists=[True, True])
    close(again, whole["hist"], 1e-6)
    chained = td.obtain_history_bev(
        whole["port"], _t(featsq), SHAPES, _t(l2iq), IMG,
        can_bus_queue=_t(canq))
    assert (chained - whole["hist"]).abs().max() > 1e-3


def test_detector_loss_and_gradients_match_jax(whole):
    boxes, labels, valid = whole["gt"]
    for cost in _loss_costs(whole["jout"], boxes, labels, valid):
        _stable_assignment(cost)
    got, want = whole["losses"], whole["jlosses"]
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_allclose(float(value.detach()), float(want[key]),
                                   rtol=2e-3, err_msg=key)
    grads_close(whole["grads"], whole["jgrads"])


def test_detector_decode_and_score(whole):
    """The decoded boxes match JAX's, and the scoring of them against the
    ground truth gives finite mAP and NDS in [0, 1]."""
    from stereoscene_torch.core.nuscenes_eval import (
        boxes_from_arrays,
        evaluate_detections,
    )

    out = {k: v.detach() for k, v in whole["out"].items()}
    got = td.bevformer_get_bboxes(out, max_num=10,
                                  post_center_range=(-12, -12, -4, 12, 12, 4))
    want = jd.bevformer_get_bboxes(whole["jout"], max_num=10,
                                   post_center_range=(-12, -12, -4, 12, 12,
                                                      4))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    close(got["boxes"], want["boxes"], 2e-3)
    boxes, labels, valid = whole["gt"]
    classes = ("car", "pedestrian", "barrier")
    gts = boxes_from_arrays(["s0"] * int(valid.sum()), boxes[0][valid[0]],
                            labels[0][valid[0]], classes=classes)
    preds = boxes_from_arrays(["s0"] * 10, got["boxes"][0].numpy(),
                              got["labels"][0].numpy(),
                              got["scores"][0].numpy(), classes=classes)
    m = evaluate_detections(gts, preds, classes=classes)
    assert 0.0 <= m.mean_ap <= 1.0 and 0.0 <= m.nd_score <= 1.0


def test_prev_frame_info_matches_jax():
    """Three frames of one scene, a new scene, then video mode off:
    prev_bev and the can_bus deltas bitwise equal."""
    rng = np.random.RandomState(6)
    frames = [("a", rng.randn(18)), ("a", rng.randn(18)),
              ("a", rng.randn(18)), ("b", rng.randn(18)),
              ("b", rng.randn(18))]
    for video in (True, False):
        ours, theirs = td.PrevFrameInfo(video), jd.PrevFrameInfo(video)
        for i, (scene, bus) in enumerate(frames):
            (p0, c0), (p1, c1) = ours.step(scene, bus), theirs.step(scene,
                                                                    bus)
            assert (p0 is None) == (p1 is None)
            if p0 is not None:
                assert p0 == p1
            assert c0.dtype == c1.dtype == np.float32
            np.testing.assert_array_equal(c0, c1)
            ours.update(f"bev{i}")
            theirs.update(f"bev{i}")
        assert (ours.prev_bev is None) == (not video)


@pytest.mark.parametrize("can_bus", [False, True])
def test_detector_weights_round_trip(can_bus):
    """Every leaf of the JAX ``init`` tree (with or without can_bus, which
    decides whether the can_bus MLP exists) maps to a port tensor of its
    shape, and distinct values go in and come back bitwise."""
    rng = np.random.RandomState(7)
    feats, l2i = _inputs(rng)
    kw = dict(can_bus=jnp.zeros((1, 18))) if can_bus else {}
    init = jax.eval_shape(lambda: jd.BEVFormerDetector(**DET).init(
        jax.random.PRNGKey(0), feats, SHAPES, l2i, IMG, **kw))["params"]
    assert ("can_bus_mlp1" in init["bev_encoder"]) == can_bus
    port = td.BEVFormerDetector(C_IN, can_bus=can_bus, device="cpu",
                                **DET)
    want = {k: v.shape for k, v in _flatten(init).items()}
    assert {k: np.shape(v) for k, v in _flatten(flax_template(port)).items()} \
        == want
    tree = distinct_tree(init)
    load_flax_params(port, tree, None)
    back = _flatten(flax_trees(port)[0])
    assert back.keys() == tree.keys()
    for key, value in tree.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
