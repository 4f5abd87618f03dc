"""The port's BEVOcc family against the JAX package's at TINY: multi-scale
deformable attention (2D and 3D, sampling points inside, on integer
pixel centres and outside every level), each BEVFormer piece
(``DeformableAttention`` with nonzero sampling offsets, the
``OccupancyEncoder`` with can_bus, ``prev_bev``, ``rotate_bev`` and
``ego_motion_shift``, ``BEVOccHead``), the multi-scale
``BEVOccupancyHead``, ``mode_pool`` with ties, both branches of
``bevocc_loss``, ``bevocc_from_config`` and the whole BEVOcc (b0 on a
32x64 image, embed 16, a 4x4x2 coarsest level, two levels) forward,
loss, gradients and BatchNorm statistics through ``flax_trees``.

Weights come from ``seeded_init_`` on the port's side (sampling offsets
nonzero) and cross as flax trees (``flax_trees`` / ``module_rules``).
Tolerances: fp32 modules within 1e-5 of their output's scale, 1e-4
after a softmax or a norm; the whole model's logits within 2e-3 of
max|ref|, loss terms rtol 2e-3; gradient leaves within 2% of the leaf
with an atol floor of 1e-4 x the global gradient scale
(tests/test_grad_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.config import Config as JConfig
from stereoscene_tpu.models import bevformer as jbf
from stereoscene_tpu.models import bevocc as jbo
from stereoscene_tpu.ops import msdeform_attn as jms
from stereoscene_torch.config import Config
from stereoscene_torch.models import bevformer, bevocc
from stereoscene_torch.ops import msdeform_attn as tms
from stereoscene_torch.utils.weights import (
    _flatten,
    flax_trees,
    load_flax_params,
    module_rules,
    rules_trees,
    seeded_init_,
)

HEAD = dict(embed_dim=16, fpn_level=2, bev_shape=(4, 4), num_z=2,
            out_channel=20, num_encoder_layers=1, norm_groups=4,
            pc_range=(0.0, -4.0, -2.0, 8.0, 4.0, 2.0))
IMG = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lidar2img(b, n):
    """A forward pinhole camera P @ [R|t] (ego x forward) on the 32x64
    image, [B, N, 3, 4]."""
    p = np.zeros((3, 4), np.float32)
    p[0, 0] = p[1, 1] = 20.0
    p[0, 2], p[1, 2], p[2, 2] = 32.0, 16.0, 1.0
    r = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                 np.float32)
    return np.broadcast_to(p @ r, (b, n, 3, 4)).copy()


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def _grads_close(got, want):
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


def _port_grads(module, rules):
    grads = {n: p.grad for n, p in module.named_parameters()
             if p.grad is not None}
    return rules_trees(module, rules, grads)[0]


def _locations(rng, shape, nd, sizes):
    """Sampling locations in [-0.15, 1.15] with a share exactly on pixel
    centres ((i + 0.5) / size: integer pixel coordinates)."""
    locs = rng.uniform(-0.15, 1.15, shape + (nd,)).astype(np.float32)
    centres = np.stack([(rng.randint(-1, s + 1, shape) + 0.5) / s
                        for s in sizes], -1).astype(np.float32)
    pick = rng.rand(*shape) < 0.3
    return np.where(pick[..., None], centres, locs)


@pytest.mark.parametrize("nd", [2, 3])
def test_msdeform_matches_jax(nd):
    rng = np.random.RandomState(nd)
    shapes = [(6, 8), (3, 4)] if nd == 2 else [(4, 6, 3), (2, 3, 2)]
    b, q, heads, pts, c = 2, 7, 2, 3, 8
    total = sum(int(np.prod(s)) for s in shapes)
    value = rng.randn(b, total, c).astype(np.float32)
    # level 0's sizes in the loc order: (w, h) in 2D, (x, y, z) in 3D
    sizes = shapes[0][::-1] if nd == 2 else shapes[0]
    locs = _locations(rng, (b, q, heads, len(shapes), pts), nd, sizes)
    assert (locs < 0).any() and (locs > 1).any()
    weights = rng.rand(b, q, heads, len(shapes), pts).astype(np.float32)
    jf, tf = ((jms.msdeform_attn, tms.msdeform_attn) if nd == 2 else
              (jms.msdeform_attn_3d, tms.msdeform_attn_3d))
    want = jf(jnp.asarray(value), shapes, jnp.asarray(locs),
              jnp.asarray(weights), heads)
    got = tf(torch.from_numpy(value), shapes, torch.from_numpy(locs),
             torch.from_numpy(weights), heads)
    _close(got, want, 1e-5)


def test_rotate_bev_and_ego_motion_shift_match_jax():
    rng = np.random.RandomState(3)
    prev = rng.randn(3, 6 * 5, 4).astype(np.float32)
    angle = np.array([0.0, 17.0, -90.0], np.float32)
    want = jbf.rotate_bev(jnp.asarray(prev), jnp.asarray(angle), (6, 5))
    got = bevformer.rotate_bev(torch.from_numpy(prev),
                               torch.from_numpy(angle), (6, 5))
    _close(got, want, 1e-5)
    _close(got[0], prev[0], 1e-6)  # 0 degrees is the identity
    can_bus = rng.randn(3, 18).astype(np.float32)
    for use_shift in (True, False):
        want = jbf.ego_motion_shift(jnp.asarray(can_bus), (8, 4), (0.5, 2.0),
                                    use_shift)
        got = bevformer.ego_motion_shift(torch.from_numpy(can_bus), (8, 4),
                                         (0.5, 2.0), use_shift)
        _close(got, want, 1e-6)


def test_deformable_attention_matches_jax():
    rng = np.random.RandomState(4)
    shapes = [(6, 8), (3, 4)]
    port = bevformer.DeformableAttention(16, 2, 3, len(shapes))
    seeded_init_(port, 1)
    assert port.sampling_offsets.weight.abs().max() > 0
    q = rng.randn(2, 10, 16).astype(np.float32)
    v = rng.randn(2, 60, 16).astype(np.float32)
    ref = rng.rand(2, 10, len(shapes), 2).astype(np.float32)
    jmod = jbf.DeformableAttention(16, 2, 3, len(shapes))
    template = jmod.init(jax.random.PRNGKey(0), q, v, shapes, ref)["params"]
    rules = module_rules(port, template)
    params, _ = rules_trees(port, rules)
    want = jmod.apply({"params": params}, q, v, shapes, ref)
    got = port(torch.from_numpy(q), torch.from_numpy(v), shapes,
               torch.from_numpy(ref))
    _close(got, want, 1e-4)


def _encoder_inputs(rng, b=2, n=2, c=16, shapes=((4, 8),)):
    total = sum(h * w for h, w in shapes)
    return (rng.randn(b, n, total, c).astype(np.float32),
            lidar2img(b, n).astype(np.float32))


@pytest.mark.parametrize("temporal", [False, True])
def test_occupancy_encoder_matches_jax(temporal):
    """The encoder with can_bus (the MLP and its norm), the rotated
    ``prev_bev`` and the ego shift when ``temporal``; plain otherwise."""
    rng = np.random.RandomState(5)
    feats, l2i = _encoder_inputs(rng)
    shapes = [(4, 8)]
    kw = dict(embed_dim=16, num_layers=2, bev_shape=(4, 4), num_z=2,
              pc_range=HEAD["pc_range"])
    extra = {}
    if temporal:
        can_bus = rng.randn(2, 18).astype(np.float32)
        can_bus[:, -1] = [12.0, -30.0]
        extra = dict(prev_bev=rng.randn(2, 16, 16).astype(np.float32),
                     can_bus=can_bus)
    pos = rng.randn(16, 16).astype(np.float32)
    port = bevformer.OccupancyEncoder(can_bus=temporal, **kw)
    seeded_init_(port, 2)
    jmod = jbf.OccupancyEncoder(**kw)
    jargs = (feats, shapes, l2i, IMG)
    template = jmod.init(jax.random.PRNGKey(0), *jargs, query_pos=pos,
                         **extra)["params"]
    rules = module_rules(port, template)
    params, _ = rules_trees(port, rules)
    cot = rng.randn(2, 16, 16).astype(np.float32)

    def jloss(p):
        out = jmod.apply({"params": p}, *jargs, query_pos=pos, **extra)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    got = port(torch.from_numpy(feats), shapes, torch.from_numpy(l2i), IMG,
               query_pos=torch.from_numpy(pos),
               **{k: torch.from_numpy(v) for k, v in extra.items()})
    ref, mask = port.project(torch.from_numpy(l2i), IMG)
    assert mask.any() and not mask.all()
    _close(got, want, 1e-4)
    (got * torch.from_numpy(cot)).sum().backward()
    _grads_close(_port_grads(port, rules), jgrads)


def test_bevformer_occ_head_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 16, 16).astype(np.float32)
    port = bevformer.BEVOccHead(16, (4, 4), 3, 20)
    seeded_init_(port, 3)
    jmod = jbf.BEVOccHead(16, (4, 4), 3, 20)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), x)["params"])
    want = jmod.apply({"params": rules_trees(port, rules)[0]}, x)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 3, 20)
    _close(got, want, 1e-5)


def test_bevocc_head_matches_jax():
    rng = np.random.RandomState(7)
    feats, l2i = _encoder_inputs(rng, c=12)
    shapes = ((4, 8),)
    port = bevocc.BEVOccupancyHead(12, **HEAD)
    seeded_init_(port, 4)
    jmod = jbo.BEVOccupancyHead(**HEAD)
    template = jmod.init(jax.random.PRNGKey(0), feats, shapes, l2i,
                         IMG)["params"]
    rules = module_rules(port, template)
    params, _ = rules_trees(port, rules)
    cots = [rng.randn(2, 4, 4, 2, 20).astype(np.float32),
            rng.randn(2, 8, 8, 4, 20).astype(np.float32)]

    def jloss(p):
        out = jmod.apply({"params": p}, feats, shapes, l2i, IMG)["occ_preds"]
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    got = port(torch.from_numpy(feats), shapes, torch.from_numpy(l2i),
               IMG)["occ_preds"]
    assert [tuple(g.shape) for g in got] == [(2, 4, 4, 2, 20),
                                              (2, 8, 8, 4, 20)]
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    _grads_close(_port_grads(port, rules), jgrads)


@pytest.mark.parametrize("ratio", [1, 2, 4])
def test_mode_pool_matches_jax(ratio):
    """Few labels, so most blocks hold ties; ignore is its own bucket."""
    rng = np.random.RandomState(ratio)
    gt = rng.choice([0, 3, 7, 255], (2, 8, 8, 4)).astype(np.int32)
    gt[0, :4, :4, :] = 255
    want = np.asarray(jbo.mode_pool(jnp.asarray(gt), ratio, 20))
    got = bevocc.mode_pool(torch.from_numpy(gt), ratio, 20).numpy()
    np.testing.assert_array_equal(got, want)
    if ratio == 2:
        blocks = gt.reshape(2, 4, 2, 4, 2, 2, 2).transpose(
            0, 1, 3, 5, 2, 4, 6).reshape(2, 4, 4, 2, 8)
        counts = np.stack([(blocks == k).sum(-1) for k in (0, 3, 7, 255)], -1)
        tied = (np.sort(counts, -1)[..., -1] == np.sort(counts, -1)[..., -2])
        assert tied.any()
        assert got[0, 0, 0, 0] == 255


@pytest.mark.parametrize("semantic", [True, False])
@pytest.mark.parametrize("iou", [False, True])
def test_bevocc_loss_matches_jax(semantic, iou):
    rng = np.random.RandomState(8)
    c = 20 if semantic else 1
    preds = [rng.randn(2, 4, 4, 2, c).astype(np.float32),
             rng.randn(2, 8, 8, 4, c).astype(np.float32)]
    gt = np.where(rng.rand(2, 8, 8, 4) < 0.15, 255,
                  rng.randint(0, 20, (2, 8, 8, 4))).astype(np.int32)
    kw = dict(use_semantic=semantic, iou_loss=iou)

    def jtotal(ps):
        losses = jbo.bevocc_loss(ps, jnp.asarray(gt), **kw)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        [jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_() for p in preds]
    got = bevocc.bevocc_loss(tp, torch.from_numpy(gt), **kw)
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_allclose(float(value.detach()), float(want[key]),
                                   rtol=1e-5,
                                   err_msg=key)
    sum(got.values()).backward()
    for t, g in zip(tp, jgrads):
        _close(t.grad, g, 1e-5)


def test_bevocc_from_config_matches_jax():
    cfg = Config.fromfile("stereoscene_torch/configs/bevocc_kitti.py")
    jcfg = JConfig.fromfile("stereoscene_tpu/configs/bevocc_kitti.py")
    assert dict(cfg) == dict(jcfg)
    model = bevocc.bevocc_from_config(cfg, device="cpu")
    jmodel = jbo.bevocc_from_config(jcfg)
    assert model.head == jmodel.head
    assert model.backbone == jmodel.backbone == "efficientnet-b0"
    head = model.pts_bbox_head
    level = head.fpn_level - 1
    assert [s * 2 ** level for s in (*head.bev_shape, head.num_z)] \
        == cfg["occ_size"]
    assert model.img_neck.out_features == 64
    assert next(model.parameters()).device.type == "cpu"


@pytest.fixture(scope="module")
def whole():
    """The port's and the JAX package's BEVOcc at TINY on the same
    weights and images: training forward, loss and gradients."""
    rng = np.random.RandomState(9)
    imgs = rng.randn(2, 1, *IMG, 3).astype(np.float32)
    l2i = lidar2img(2, 1)
    gt = np.where(rng.rand(2, 8, 8, 4) < 0.1, 255,
                  rng.randint(0, 20, (2, 8, 8, 4))).astype(np.int32)
    model = bevocc.BEVOcc(HEAD, "efficientnet-b0", neck_out=12, device="cpu")
    seeded_init_(model, 6)
    params, stats = flax_trees(model)
    jm = jbo.BEVOcc(head=HEAD, backbone="efficientnet-b0", neck_out=12)

    def jeval(p, s):
        return jm.apply({"params": p, "batch_stats": s}, imgs, l2i)

    def jloss(p, s):
        out, mutated = jm.apply({"params": p, "batch_stats": s}, imgs, l2i,
                                train=True, mutable=["batch_stats"])
        losses = jbo.bevocc_loss(out["occ_preds"], jnp.asarray(gt))
        return sum(losses.values()), (losses, mutated["batch_stats"])

    jout = jax.jit(jeval)(params, stats)
    (_, (jlosses, jstats)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params, stats)

    with torch.no_grad():
        out = model(torch.from_numpy(imgs), torch.from_numpy(l2i))
    model.train()
    losses = bevocc.bevocc_loss(
        model(torch.from_numpy(imgs), torch.from_numpy(l2i))["occ_preds"],
        torch.from_numpy(gt))
    sum(losses.values()).backward()
    grads = flax_trees(model, {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None})[0]
    return dict(out=out, jout=jout, losses=losses, jlosses=jlosses,
                grads=grads, jgrads=jgrads, stats=flax_trees(model)[1],
                jstats=jstats, stats0=stats, model=model, params=params)


def test_bevocc_weights_round_trip(whole):
    """``load_flax_params`` fills every tensor but the backbone's unused
    head conv, and gives back what ``flax_trees`` gave."""
    fresh = bevocc.BEVOcc(HEAD, "efficientnet-b0", neck_out=12, device="cpu")
    load_flax_params(fresh, whole["params"], whole["stats0"])
    want = whole["model"].state_dict()
    head = f"img_backbone.layers.{len(fresh.img_backbone.layers) - 1}."
    for key, value in fresh.state_dict().items():
        if key.startswith(head) or key.endswith("num_batches_tracked"):
            continue
        if key.endswith(("running_mean", "running_var")):
            continue  # the fixture's training forward moved them
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)


def test_bevocc_forward_matches_jax(whole):
    got, want = whole["out"], whole["jout"]
    assert [tuple(p.shape) for p in got["occ_preds"]] == [
        (2, 4, 4, 2, 20), (2, 8, 8, 4, 20)]
    for g, w in zip(got["occ_preds"], want["occ_preds"]):
        _close(g, w, 2e-3)
    _close(got["bev_embed"], want["bev_embed"], 2e-3)


def test_bevocc_train_step_matches_jax(whole):
    assert whole["losses"].keys() == whole["jlosses"].keys()
    for key, value in whole["losses"].items():
        np.testing.assert_allclose(float(value.detach()),
                                   float(whole["jlosses"][key]), rtol=2e-3,
                                   err_msg=key)
    _grads_close(whole["grads"], whole["jgrads"])
    for key, want in _flatten(whole["jstats"]).items():
        want = np.asarray(want)
        assert not np.array_equal(want,
                                  np.asarray(_flatten(whole["stats0"])[key]))
        np.testing.assert_allclose(_flatten(whole["stats"])[key], want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)
