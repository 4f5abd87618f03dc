"""The port's optional model branches against the JAX package's at TINY:
CRP3D (``CPMegaVoxels`` fed the relation matrix of the label producer, and
``crp_relation_loss``), the OccHead point branch and its two samplers, the
imgseg head, the whole detector with every switch on in eval mode, the
refusal of a 33-wide camera vector (a 4x4 ``bda``) and the weight bridge of
the new parameters.

Tolerances: module outputs within 1e-5 of their scale in fp32, module
parameter gradients within 2% of each leaf (floor 1e-4 of the global
scale); the detector's logits, point logits, imgseg logits and relation
logits within 2e-3 of max|ref|, depth_prob within 2e-4
(tests/test_full_model_parity.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from stereoscene_tpu.data import labels as jlabels
from stereoscene_tpu.models import crp3d as jcrp
from stereoscene_tpu.models import occhead as jocc
from stereoscene_tpu.models.depth_net import BasicBlock2d as JBasicBlock2d
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.layers import Conv2d as JConv2d
from stereoscene_torch.models import crp3d, occhead
from stereoscene_torch.models.detector import BEVDepthOccupancy
from stereoscene_torch.models.detector import DetectorConfig
from stereoscene_torch.utils.weights import (
    _flatten,
    _unflatten,
    flax_name_map,
    flax_trees,
    load_flax_params,
    seeded_init_,
)
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import japply

# TINY on a 16x16x8 grid of 0.5 m voxels, so that stage 2 of the voxel
# encoder (4x4x2) takes 2x2x1 mega-voxels and the relation labels of
# compute_cp_mega_matrix at (4, 4, 2); every optional switch on
ALL = dataclasses.replace(
    TINY, xbound=(0.0, 8.0, 0.5), ybound=(-4.0, 4.0, 0.5),
    zbound=(-2.0, 2.0, 0.5), use_grid_mask=True, imgseg=True, crp3d=True,
    crp_mega_shape=(2, 2, 1), supervise_points=True)
N_POINTS = 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU at once, and a full torch thread pool in each makes
    the CPU's bf16 and conv kernels crawl (oversubscription)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sub_params(sd, rules, flax_prefix, port_prefix):
    """The flax tree of the tensors ``sd`` (a submodule's, keyed as the
    detector's keys less ``port_prefix``) under the detector's name
    map."""
    flat = {}
    for path, (key, _, inv) in rules.items():
        if path.startswith(flax_prefix):
            value = sd[key[len(port_prefix):]].detach().float().numpy()
            flat[path[len(flax_prefix):]] = np.ascontiguousarray(inv(value))
    return _unflatten(flat)


def _grads_close(got, want):
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys()
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert scale > 1e-3
    for key, w in want.items():
        w, g = np.asarray(w), np.asarray(got[key])
        leaf = max(np.abs(w).max(), np.abs(g).max(), 1e-6)
        err = np.abs(g - w).max()
        assert err <= max(2e-2 * leaf, 1e-4 * scale), (key, err / leaf)


def _rel_logits_inputs(seed):
    """Stage features [B, 8, 8, 4, C] and the producer's 4-way relation
    matrix of a [8, 8, 4] target (2x2x2 mega-voxels: 4x4x2)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 8, 8, 4, 16).astype(np.float32)
    targets = rng.choice([0, 1, 9, 255], (2, 8, 8, 4),
                         p=[0.5, 0.2, 0.2, 0.1]).astype(np.uint8)
    cp = np.stack([jlabels.compute_cp_mega_matrix(t) for t in targets])
    return x, cp


def test_cp_mega_voxels_and_relation_loss_match_jax():
    x, cp = _rel_logits_inputs(0)
    assert cp.shape == (2, 4, 256, 32) and cp.any()
    torch.manual_seed(0)
    port = crp3d.CPMegaVoxels(16, (4, 4, 2), norm_groups=4)
    seeded_init_(port, 3)
    rules = flax_name_map(dataclasses.replace(
        DetectorConfig(**dataclasses.asdict(TINY)), crp3d=True)).params
    params = _sub_params(port.state_dict(), rules,
                         "img_bev_encoder_backbone/cp_mega_voxels/",
                         "img_bev_encoder_backbone.cp_mega_voxels.")
    jmod = jcrp.CPMegaVoxels(channels=16, mega_shape=(4, 4, 2),
                             norm_groups=4)
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        out, logits = jmod.apply({"params": p}, xx)
        rel = jcrp.crp_relation_loss(logits, jnp.asarray(cp))
        return jnp.sum(out * cot) + 10.0 * rel, (out, logits, rel)

    (_, (jout, jlogits, jrel)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    out, logits = port(xt)
    rel = crp3d.crp_relation_loss(logits, torch.from_numpy(cp))
    total = (out.permute(0, 2, 3, 4, 1) * torch.from_numpy(cot)).sum() \
        + 10.0 * rel
    total.backward()
    for got, want in ((out.permute(0, 2, 3, 4, 1), jout), (logits, jlogits)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(rel.detach()), float(jrel), rtol=1e-5)
    gx = np.asarray(jgx)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(), gx,
                               rtol=0, atol=1e-5 * np.abs(gx).max())
    grads = _sub_params(
        {n: p.grad for n, p in port.named_parameters()},
        rules, "img_bev_encoder_backbone/cp_mega_voxels/",
        "img_bev_encoder_backbone.cp_mega_voxels.")
    _grads_close(grads, jgp)


def test_point_samplers_match_jax():
    rng = np.random.RandomState(2)
    vol = rng.randn(2, 6, 5, 4, 7).astype(np.float32)
    # inside, on the edges and outside the grid
    pts = rng.uniform(-1.3, 1.3, (2, 50, 3)).astype(np.float32)
    pts[:, :3] = [[-1, -1, -1], [1, 1, 1], [0.999, -0.999, 0]]
    got = occhead.trilinear_point_sample(torch.from_numpy(vol),
                                         torch.from_numpy(pts))
    want = jax.vmap(jocc.trilinear_point_sample)(jnp.asarray(vol),
                                                 jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    feat = rng.randn(2, 8, 16, 5).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32)
    got = occhead.bilinear_image_sample(torch.from_numpy(feat),
                                        torch.from_numpy(uv))
    want = jax.vmap(jocc.bilinear_image_sample)(jnp.asarray(feat),
                                                jnp.asarray(uv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("img,soft", [(False, False), (True, False),
                                      (True, True)])
def test_occhead_point_branch_matches_jax(img, soft):
    rng = np.random.RandomState(4)
    vox = rng.randn(2, 6, 6, 4, 24).astype(np.float32)
    pts = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    feats = rng.randn(2, 8, 16, 12).astype(np.float32)
    uv = rng.uniform(-1, 1, (2, 40, 2)).astype(np.float32)
    cot = rng.randn(2, 40, 20).astype(np.float32)
    head = occhead.OccHead(24, 20, 4, supervise_points=True,
                           sampling_img_feats=img, soft_weights=soft,
                           in_img_channels=12)
    seeded_init_(head, 5)

    class Holder(torch.nn.Module):  # the detector's key prefix
        def __init__(self):
            super().__init__()
            self.pts_bbox_head = head

    cfg = DetectorConfig(**dataclasses.asdict(TINY))
    rules = flax_name_map(cfg, head).params
    holder = Holder()
    params = _sub_params(holder.state_dict(), rules, "pts_bbox_head/", "")
    jmod = jocc.OccHead(in_channels=[24], out_channel=20, norm_groups=4,
                        supervise_points=True, sampling_img_feats=img,
                        soft_weights=soft)

    def jloss(p):
        out = jmod.apply({"params": p}, [jnp.asarray(vox)],
                         points=jnp.asarray(pts),
                         img_feats=jnp.asarray(feats),
                         points_uv=jnp.asarray(uv))
        return jnp.sum(out["output_points"] * cot), out["output_points"]

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    got = head.forward_points(torch.from_numpy(vox).permute(0, 4, 1, 2, 3),
                              torch.from_numpy(pts),
                              torch.from_numpy(feats).permute(0, 3, 1, 2),
                              torch.from_numpy(uv))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    (got * torch.from_numpy(cot)).sum().backward()
    grads = _sub_params(
        {n: p.grad for n, p in holder.named_parameters()},
        {k: v for k, v in rules.items() if "occ_conv" not in k},
        "pts_bbox_head/", "")
    want_grads = {k: v for k, v in jgrads.items() if "occ_conv" not in k}
    _grads_close(grads, want_grads)
    # the map's forward transforms give the head back from the JAX tree
    head2 = occhead.OccHead(24, 20, 4, supervise_points=True,
                            sampling_img_feats=img, soft_weights=soft,
                            in_img_channels=12)
    seeded_init_(head2, 9)
    flat = _flatten(params)
    with torch.no_grad():
        for path, (key, fwd, _) in rules.items():
            if not path.startswith("pts_bbox_head/"):
                continue
            head2.state_dict()[key[len("pts_bbox_head."):]].copy_(
                torch.from_numpy(np.ascontiguousarray(fwd(np.asarray(
                    flat[path[len("pts_bbox_head/"):]])))))
    for key, value in head.state_dict().items():
        torch.testing.assert_close(head2.state_dict()[key], value, rtol=0,
                                   atol=0)


class _JImgSeg(fnn.Module):
    n: int

    @fnn.compact
    def __call__(self, x):
        x = JBasicBlock2d(self.n, name="imgseg_block0")(x, train=True)
        x = JBasicBlock2d(self.n, name="imgseg_block1")(x, train=True)
        return JConv2d(20, 1, name="imgseg_head")(x)


@pytest.fixture(scope="module")
def detector():
    cfg = DetectorConfig(**dataclasses.asdict(ALL))
    model = BEVDepthOccupancy(cfg, device="cpu")
    seeded_init_(model, 7)
    params, stats = flax_trees(model)
    return model, params, stats


def test_imgseg_head_matches_jax_in_training(detector):
    """Training mode: BatchNorm on batch statistics; the head's output and
    its parameter gradients."""
    model, params, stats = detector
    n = sum(ALL.neck_out_channels)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 16, n).astype(np.float32)
    cot = rng.randn(2, 8, 16, 20).astype(np.float32)
    keys = ("imgseg_block0", "imgseg_block1", "imgseg_head")
    jp = {k: params[k] for k in keys}
    js = {k: stats[k] for k in keys if k in stats}

    def jloss(p):
        y, _ = _JImgSeg(n).apply({"params": p, "batch_stats": js},
                                 jnp.asarray(x), mutable=["batch_stats"])
        return jnp.sum(y * cot), y

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    # the training forward moves the shared model's BatchNorm statistics;
    # the module's other tests hold it to ``stats``, so they are put back
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    try:
        y = model.imgseg_head(model.imgseg_block1(model.imgseg_block0(
            torch.from_numpy(x).permute(0, 3, 1, 2)))).permute(0, 2, 3, 1)
        params_t = [p for n_, p in model.named_parameters()
                    if n_.startswith("imgseg")]
        grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                    params_t)
    finally:
        model.eval()
        model.load_state_dict(saved)
    want = np.asarray(want)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    by_name = dict(zip([n_ for n_, _ in model.named_parameters()
                        if n_.startswith("imgseg")], grads))
    got, _ = flax_trees(model, by_name)
    _grads_close({k: got[k] for k in keys}, jgrads)


def _all_batch(seed, b=2):
    rng = np.random.RandomState(seed)
    batch = {k: np.array(v) for k, v in _tiny_batch(b=b, rng=rng).items()}
    lo = [ALL.xbound[0], ALL.ybound[0], ALL.zbound[0]]
    hi = [ALL.xbound[1], ALL.ybound[1], ALL.zbound[1]]
    xyz = rng.uniform(lo, hi, (b, N_POINTS, 3))
    batch["points_occ"] = np.concatenate(
        [xyz, rng.randint(0, 20, (b, N_POINTS, 1))], -1).astype(np.float32)
    batch["points_uv"] = rng.uniform(-1, 1, (b, N_POINTS, 3)).astype(
        np.float32)
    return batch


def test_detector_with_every_switch_matches_jax_in_eval(detector):
    model, params, stats = detector
    batch = _all_batch(3)
    want = japply(JaxModel(cfg=ALL), {"params": params,
                                      "batch_stats": stats},
                  {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    got = model({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["depth_prob"].numpy(),
                               np.asarray(want["depth_prob"]), rtol=0,
                               atol=2e-4)
    pairs = (("output_voxels", want["output_voxels"][0]),
             ("output_points", want["output_points"]),
             ("imgseg_logits", want["imgseg_logits"]),
             ("crp_logits", want["crp_logits"]))
    shapes = {"output_voxels": (2, 16, 16, 8, 20),
              "output_points": (2, N_POINTS, 20),
              "imgseg_logits": (2, 8, 16, 20),
              "crp_logits": (2, 4, 32, 4)}
    for name, ref in pairs:
        ref = np.asarray(ref)
        out = got[name].numpy()
        assert out.shape == ref.shape == shapes[name], name
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out / scale, ref / scale, rtol=0,
                                   atol=2e-3, err_msg=name)


def test_switches_off_give_no_optional_outputs():
    model = BEVDepthOccupancy(DetectorConfig(**dataclasses.asdict(TINY)),
                              device="cpu")
    out = model({k: torch.from_numpy(v) for k, v in _all_batch(4).items()})
    assert set(out) == {"output_voxels", "depth_prob"}


def test_weight_bridge_round_trip_covers_the_new_parameters(detector):
    model, params, stats = detector
    flat = _flatten(params)
    for prefix in ("img_bev_encoder_backbone/cp_mega_voxels/",
                   "imgseg_block0/", "imgseg_block1/", "imgseg_head/",
                   "pts_bbox_head/point_occ_mlp/"):
        assert any(k.startswith(prefix) for k in flat), prefix
    other = BEVDepthOccupancy(DetectorConfig(**dataclasses.asdict(ALL)),
                              device="cpu")
    seeded_init_(other, 99)
    load_flax_params(other, params, stats)
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(other.state_dict()[key], value,
                                       rtol=0, atol=0, msg=key)


def test_bda4_camera_vector_is_refused_by_both_packages(detector):
    """A 4x4 bda makes the camera vector 33 wide; the JAX DepthNet's
    GroupNorm(2) refuses it, the port's DepthNet refuses it by name."""
    model, params, stats = detector
    batch = _all_batch(5, b=1)
    bda = np.eye(4, dtype=np.float32)[None]
    bda[0, :3, 3] = [0.5, -0.2, 0.1]
    batch["bda"] = bda
    with pytest.raises(ValueError, match="33"):
        model({k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(Exception, match="33"):  # raised while tracing
        jax.eval_shape(
            lambda v, b: JaxModel(cfg=ALL).apply(v, b, train=False),
            {"params": params, "batch_stats": stats},
            {k: jnp.asarray(v) for k, v in batch.items()})
