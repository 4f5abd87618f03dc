"""The flagship family's variant modules of the port against the JAX
package's at TINY: ``DepthAggregation``, the temporal alignment
(``models/temporal.py``), the alternate 3D necks, ``SharedOccHead``, the
voxel encoders, the BEVStereo pieces (``DepthNetStereo`` with nonzero DCN
offsets, ``homo_warp`` with candidates behind the camera, the similarity
net, the Gaussian candidates, EM and the depth distribution), ViT, VoVNet
and the EdgeTPU EfficientNets.

Weights come from ``seeded_init_`` on the port's side and cross as flax
trees read off the JAX module's own ``init`` (``module_rules``).
Tolerances: fp32 outputs within 1e-5 of their scale, 1e-4 after a
softmax or a norm; parameter gradients within 2% of the leaf with an
atol floor of 1e-4 x the global gradient scale
(tests/test_grad_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models import bev_stereo as jbs
from stereoscene_tpu.models import efficientnet as jeff
from stereoscene_tpu.models import necks3d as jnecks
from stereoscene_tpu.models import shared_occhead as jshared
from stereoscene_tpu.models import temporal as jtemporal
from stereoscene_tpu.models import voxel_encoder as jvox
from stereoscene_tpu.models.depth_net import DepthAggregation as JDepthAgg
from stereoscene_tpu.models.vit import ViT as JViT
from stereoscene_tpu.models.vovnet import VoVNet as JVoVNet
from stereoscene_tpu.ops.resize import resize_trilinear as jresize
from stereoscene_torch.models import (
    bev_stereo,
    efficientnet,
    necks3d,
    shared_occhead,
    temporal,
    voxel_encoder,
)
from stereoscene_torch.models.depth_net import DepthAggregation
from stereoscene_torch.models.vit import ViT
from stereoscene_torch.models.vovnet import VoVNet
from stereoscene_torch.ops.resize import resize_trilinear
from stereoscene_torch.utils.weights import (
    _Map,
    _flatten,
    efficientnet_rules,
    module_rules,
    rules_trees,
    seeded_init_,
)

ASPP_NAMES = [(f"aspp/aspp{i}_conv", f"aspp/aspp{i}/atrous_conv")
              for i in (1, 2, 3, 4)] + [
    (f"aspp/aspp{i}_bn", f"aspp/aspp{i}/bn") for i in (1, 2, 3, 4)] + [
    ("aspp/gap_conv", "aspp/global_avg_pool/1"),
    ("aspp/gap_gn", "aspp/global_avg_pool/2"),
    ("aspp/out_conv", "aspp/conv1"), ("aspp/out_bn", "aspp/bn1")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def _grads_close(got, want):
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys()
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert scale > 1e-4
    bad = []
    for key, w in want.items():
        w, g = np.asarray(w), np.asarray(got[key])
        leaf = max(np.abs(w).max(), np.abs(g).max(), 1e-6)
        err = np.abs(g - w).max()
        if err > max(2e-2 * leaf, 1e-4 * scale):
            bad.append((key, float(err / leaf)))
    assert not bad, bad[:8]


def _cf(x):
    """Channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _cl(t):
    """Channels-first tensor -> channels-last tensor."""
    return torch.movedim(t, 1, -1)


def _bridge(port, jmod, jargs, seed, renames=(), rules=None, **kw):
    """Seeded port weights as the JAX module's variables, and the rules."""
    seeded_init_(port, seed)
    if rules is None:
        variables = jmod.init(jax.random.PRNGKey(0), *jargs, **kw)
        rules = module_rules(port, variables["params"],
                             variables.get("batch_stats"), renames)
    params, stats = rules_trees(port, rules)
    return {"params": params, "batch_stats": stats} if stats else {
        "params": params}, rules


def _check_module(port, jmod, jargs, targs, to_jax, seed, tol=1e-4,
                  renames=(), rules=None, **kw):
    """Forward and parameter gradients of <output, cotangent> (eval
    mode) against JAX; ``to_jax`` maps the port's output to JAX's
    layout."""
    variables, rules = _bridge(port, jmod, jargs, seed, renames, rules, **kw)
    want = jax.jit(lambda v: jmod.apply(v, *jargs, **kw))(variables)
    port.eval()
    got = to_jax(port(*targs))
    flat_w = jax.tree_util.tree_leaves(want)
    flat_g = [g for g in jax.tree_util.tree_leaves(
        got, is_leaf=torch.is_tensor)]
    assert len(flat_w) == len(flat_g)
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*np.shape(w)).astype(np.float32) for w in flat_w]
    for g, w in zip(flat_g, flat_w):
        _close(g, w, tol)

    def jloss(p):
        out = jmod.apply(dict(variables, params=p), *jargs, **kw)
        return sum(jnp.sum(o * c) for o, c in
                   zip(jax.tree_util.tree_leaves(out), cots))

    jgrads = jax.jit(jax.grad(jloss))(variables["params"])
    sum((g * torch.from_numpy(c)).sum() for g, c in zip(flat_g, cots)
        ).backward()
    grads = {n: p.grad for n, p in port.named_parameters()
             if p.grad is not None}
    _grads_close(rules_trees(port, rules, grads)[0], jgrads)


def test_depth_aggregation_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 6, 10, 12).astype(np.float32)  # [N, W, D, C]
    port = DepthAggregation(12, 8, 5)
    _check_module(port, JDepthAgg(8, 5), (x,), (_cf(x),),
                  lambda y: _cl(y), seed=1)


def test_depth_aggregation_train_statistics_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 6, 10, 12).astype(np.float32)
    port = DepthAggregation(12, 8, 5)
    jmod = JDepthAgg(8, 5)
    variables, rules = _bridge(port, jmod, (x,), 2)
    want, mutated = jmod.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    port.train()
    got = port(_cf(x))
    _close(_cl(got), want, 1e-4)
    _, stats = rules_trees(port, rules)
    for key, value in _flatten(mutated["batch_stats"]).items():
        _close(_flatten(stats)[key], value, 1e-4)


def _poses(rng, b):
    def rot(yaw):
        c, s = np.cos(yaw), np.sin(yaw)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    rots = np.stack([rot(a) for a in rng.uniform(-0.3, 0.3, b)])[:, None]
    trans = rng.uniform(-1.5, 1.5, (b, 1, 3)).astype(np.float32)
    return {"rots": rots, "trans": trans}


def test_temporal_alignment_matches_jax():
    rng = np.random.RandomState(2)
    dx = np.array([0.5, 0.5, 0.5], np.float32)
    bx = np.array([0.25, -3.75, -1.75], np.float32)
    curr = rng.randn(2, 16, 16, 4, 6).astype(np.float32)
    prev = rng.randn(2, 16, 16, 4, 6).astype(np.float32)
    bc, bp = _poses(rng, 2), _poses(rng, 2)
    want_tf = jtemporal.relative_bev_transform(
        bc["rots"][:, 0], bc["trans"][:, 0], bp["rots"][:, 0],
        bp["trans"][:, 0])
    got_tf = temporal.relative_bev_transform(
        *(torch.from_numpy(a) for a in (bc["rots"][:, 0], bc["trans"][:, 0],
                                        bp["rots"][:, 0], bp["trans"][:, 0])))
    _close(got_tf, want_tf, 1e-6)
    want = jtemporal.fuse_temporal_voxel_features(
        jnp.asarray(curr), jnp.asarray(prev), bc, bp, dx, bx)
    tprev = torch.from_numpy(prev).requires_grad_()
    got = temporal.fuse_temporal_voxel_features(
        torch.from_numpy(curr), tprev,
        {k: torch.from_numpy(v) for k, v in bc.items()},
        {k: torch.from_numpy(v) for k, v in bp.items()}, dx, bx)
    _close(got, want, 1e-5)
    aligned = got[..., 6:]
    assert (aligned == 0).any() and (aligned != 0).float().mean() > 0.5
    assert not got.requires_grad  # detach_prev: no gradient to prev
    got = temporal.fuse_temporal_voxel_features(
        torch.from_numpy(curr), tprev,
        {k: torch.from_numpy(v) for k, v in bc.items()},
        {k: torch.from_numpy(v) for k, v in bp.items()}, dx, bx,
        detach_prev=False)
    got.sum().backward()
    assert tprev.grad.abs().sum() > 0


@pytest.mark.parametrize("out_xyz", [(4, 4, 2), (3, 5, 2), (8, 4, 2)])
def test_resize_down_matches_jax(out_xyz):
    x = np.random.RandomState(3).randn(2, 8, 8, 4, 5).astype(np.float32)
    _close(resize_trilinear(torch.from_numpy(x), out_xyz),
           jresize(jnp.asarray(x), out_xyz), 1e-6)


def _pyramid(rng):
    return [rng.randn(2, 8, 8, 4, 8).astype(np.float32),
            rng.randn(2, 4, 4, 2, 16).astype(np.float32),
            rng.randn(2, 2, 2, 1, 32).astype(np.float32)]


@pytest.mark.parametrize("kind", ["fpn3d", "spconv"])
def test_necks3d_match_jax(kind):
    feats = _pyramid(np.random.RandomState(4))
    if kind == "fpn3d":
        port = necks3d.FPN3D((8, 16, 32), 16, num_upsample=1, norm_groups=4)
        jmod = jnecks.FPN3D(in_channels=(8, 16, 32), out_channels=16,
                            num_upsample=1, norm_groups=4)
    else:
        port = necks3d.SpconvNeck3D((8, 16, 32), 16, norm_groups=4)
        jmod = jnecks.SpconvNeck3D(in_channels=(8, 16, 32), out_channels=16,
                                   norm_groups=4)
    _check_module(port, jmod, (feats,), ([_cf(f) for f in feats],),
                  lambda outs: [_cl(o) for o in outs], seed=5)


@pytest.mark.parametrize("img", [False, True])
def test_shared_occhead_matches_jax(img):
    rng = np.random.RandomState(6)
    pcr = (0.0, -4.0, -2.0, 8.0, 4.0, 2.0)
    grid = rng.randn(2, 8, 8, 4, 16).astype(np.float32)
    pts = np.stack([rng.uniform(-0.5, 8.5, (2, 30)),
                    rng.uniform(-4.5, 4.5, (2, 30)),
                    rng.uniform(-2.5, 2.5, (2, 30))], -1).astype(np.float32)
    kw = {}
    if img:
        kw = dict(img_feats=rng.randn(2, 6, 10, 12).astype(np.float32),
                  points_uv=rng.uniform(-1, 1, (2, 30, 2)).astype(
                      np.float32))
    port = shared_occhead.SharedOccHead(16, 20, 32, sampling_img_feats=img,
                                        in_img_channels=12,
                                        point_cloud_range=pcr)
    jmod = jshared.SharedOccHead(in_channels=16, out_channel=20,
                                 hidden_dims=32, sampling_img_feats=img,
                                 point_cloud_range=pcr)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    variables, rules = _bridge(port, jmod, ([grid],), 7, points=pts, **kw)
    want = jmod.apply(variables, [grid], points=pts, **kw)
    got = port([torch.from_numpy(grid)], torch.from_numpy(pts), **tkw)
    _close(got["output_voxels"][0], want["output_voxels"][0], 1e-5)
    _close(got["output_points"], want["output_points"], 1e-5)
    # a voxel cell's centre decoded as a point gives its voxel logits
    centre = torch.tensor([[[3.5, -1.5, -0.5]]]).expand(2, 1, 3)
    cell = port([torch.from_numpy(grid)], centre)["output_points"][:, 0]
    torch.testing.assert_close(
        cell, got["output_voxels"][0][:, 3, 2, 1], rtol=1e-5, atol=1e-5)


def test_voxelize_points_matches_jax():
    rng = np.random.RandomState(8)
    pcr = (0.0, -4.0, -2.0, 8.0, 4.0, 2.0)
    pts = np.stack([rng.uniform(-1, 9, 300), rng.uniform(-5, 5, 300),
                    rng.uniform(-3, 3, 300)], -1).astype(np.float32)
    feats = rng.randn(300, 5).astype(np.float32)
    valid = rng.rand(300) < 0.8
    want = jvox.voxelize_points(jnp.asarray(pts), jnp.asarray(feats),
                                jnp.asarray(valid), (8, 8, 4), pcr)
    got = voxel_encoder.voxelize_points(
        torch.from_numpy(pts), torch.from_numpy(feats),
        torch.from_numpy(valid), (8, 8, 4), pcr)
    _close(got, want, 1e-6)
    assert (got != 0).any(-1).sum() > 20


@pytest.mark.parametrize("kind", ["encoder", "unet"])
def test_voxel_encoders_match_jax(kind):
    x = np.random.RandomState(9).randn(2, 8, 8, 8, 6).astype(np.float32)
    if kind == "encoder":
        port = voxel_encoder.DenseSparseEncoder(6, 8, (8, 16), 16,
                                                norm_groups=4)
        jmod = jvox.DenseSparseEncoder(base_channels=8,
                                       encoder_channels=(8, 16),
                                       out_channels=16, norm_groups=4)
    else:
        port = voxel_encoder.DenseUNet3D(6, (8, 16, 16), norm_groups=4)
        jmod = jvox.DenseUNet3D(channels=(8, 16, 16), norm_groups=4)
    _check_module(port, jmod, (x,), (_cf(x),), _cl, seed=10)


def test_depth_net_stereo_matches_jax():
    rng = np.random.RandomState(11)
    x = rng.randn(2, 6, 10, 12).astype(np.float32)
    cam = rng.randn(2, 27).astype(np.float32)
    port = bev_stereo.DepthNetStereo(12, 16, 8, 10)
    jmod = jbs.DepthNetStereo(mid_channels=16, context_channels=8,
                              depth_channels=10)
    _check_module(port, jmod, (x, cam), (_cf(x), torch.from_numpy(cam)),
                  lambda out: {k: _cl(v) for k, v in out.items()}, seed=12,
                  renames=ASPP_NAMES)
    assert port.dcn.conv_offset.weight.abs().max() > 0


def test_homo_warp_and_similarity_match_jax():
    rng = np.random.RandomState(13)
    b, h, w, c, k = 2, 6, 10, 16, 5
    src = rng.randn(b, h, w, c).astype(np.float32)
    key = rng.randn(b, h, w, c).astype(np.float32)
    intrin = np.array([[8.0, 0, 5.0], [0, 8.0, 3.0], [0, 0, 1]], np.float32)
    intrin = np.broadcast_to(intrin, (b, 3, 3)).copy()
    key2src = np.broadcast_to(np.eye(4, dtype=np.float32), (b, 4, 4)).copy()
    key2src[:, :3, 3] = [[0.3, 0.05, 0.2], [-0.4, 0.0, -2.5]]
    depth = rng.uniform(1.0, 12.0, (b, k, h, w)).astype(np.float32)
    args = (src, key2src, intrin, intrin, depth)
    want = jbs.homo_warp(*(jnp.asarray(a) for a in args))
    got = bev_stereo.homo_warp(*(torch.from_numpy(a) for a in args))
    _close(got, want, 1e-5)
    assert (got[1] == 0).all(-1).any()  # behind the source camera or out
    port = bev_stereo.StereoSimilarityNet(4)
    jmod = jbs.StereoSimilarityNet(4)
    warped = np.array(want)
    _check_module(port, jmod, (key, warped),
                  (torch.from_numpy(key), torch.from_numpy(warped)),
                  lambda y: y, seed=14)


def test_gaussian_depth_and_em_match_jax():
    rng = np.random.RandomState(15)
    mu, sigma = (rng.randn(2, 6, 10).astype(np.float32) for _ in range(2))
    scores = rng.randn(2, 7, 6, 10).astype(np.float32)
    bound = (2.0, 58.0, 0.5)
    want = jbs.gaussian_depth_candidates(jnp.asarray(mu), jnp.asarray(sigma),
                                         7, bound)
    got = bev_stereo.gaussian_depth_candidates(
        torch.from_numpy(mu), torch.from_numpy(sigma), 7, bound)
    _close(got, want, 1e-6)
    cands = np.array(want)
    jm, js = jbs.em_refine(jnp.asarray(mu) * 10 + 30,
                           jnp.abs(jnp.asarray(sigma)) + 1,
                           jnp.asarray(cands), jnp.asarray(scores), iters=3)
    tm, ts = bev_stereo.em_refine(
        torch.from_numpy(mu) * 10 + 30, torch.from_numpy(sigma).abs() + 1,
        torch.from_numpy(cands), torch.from_numpy(scores), iters=3)
    _close(tm, jm, 1e-5)
    _close(ts, js, 1e-4)
    want = jbs.depth_distribution_from_gaussian(jm, js, bound, 112)
    got = bev_stereo.depth_distribution_from_gaussian(tm, ts, bound, 112)
    _close(got, want, 1e-4)


def test_vit_matches_jax():
    x = np.random.RandomState(16).randn(2, 32, 64, 3).astype(np.float32)
    port = ViT((32, 64), patch_size=16, embed_dim=32, depth=2, num_heads=4)
    jmod = JViT(patch_size=16, embed_dim=32, depth=2, num_heads=4)
    _check_module(port, jmod, (x,), (_cf(x),),
                  lambda outs: [_cl(o) for o in outs], seed=17)


def test_vovnet_matches_jax():
    x = np.random.RandomState(18).randn(2, 64, 96, 3).astype(np.float32)
    kw = dict(stage_channels=(8, 8, 16, 16), concat_channels=(16, 16, 32, 32),
              blocks_per_stage=(1, 2, 1, 1))
    port = VoVNet(**kw)
    _check_module(port, JVoVNet(**kw), (x,), (_cf(x),),
                  lambda outs: [_cl(o) for o in outs], seed=19)


@pytest.mark.parametrize("arch", ["es", "em", "el"])
def test_edgetpu_stage_settings_match_jax(arch):
    assert efficientnet.scaled_stage_settings(arch) \
        == jeff.scaled_stage_settings(arch)


def test_edgetpu_es_matches_jax():
    x = np.random.RandomState(20).randn(2, 64, 64, 3).astype(np.float32)
    out_indices = (2, 3, 4, 5, 6)

    class Holder(torch.nn.Module):  # the detector's key prefix
        def __init__(self):
            super().__init__()
            self.img_backbone = efficientnet.CustomEfficientNet(
                "es", out_indices)

        def forward(self, img):
            return self.img_backbone(img)

    class JHolder(jeff.nn.Module):
        @jeff.nn.compact
        def __call__(self, img):
            return jeff.CustomEfficientNet(
                arch="es", out_indices=out_indices, name="img_backbone")(img)

    port = Holder()
    rules = _Map()
    efficientnet_rules(rules, "es")
    blocks = [type(b).__name__ for stage in port.img_backbone.layers[1:-1]
              for b in stage]
    assert "EdgeResidual" in blocks and "InvertedResidual" in blocks
    _check_module(port, JHolder(), (x,), (_cf(x),),
                  lambda outs: [_cl(o) for o in outs], seed=21, rules=rules)
