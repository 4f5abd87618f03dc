"""The branches that read the whole grid, on a sharded grid: CRP3D, the
point branch and the OHEM, dice and LGA voxel terms, at TINY on two gloo
CPU ranks laid out (data 1, space 2), against the port in one process.

One spawn of two ranks (tests/torch_ranks.py ``spatial_branches``, no JAX
there) runs every case in one process group; the pytest process computes
the one-process results meanwhile.

- Each branch alone and all of them together, each with ce, sem_scal and
  geo_scal and the depth loss: a train step's losses within 1e-5
  relative of one process's, every gradient leaf within max(2e-2 * leaf,
  1e-4 * global scale), the running statistics within 1e-5 of scale, both
  ranks equal; the eval forward gathered whole within 1e-5 of max|ref|.
- OHEM with a tie at its threshold that straddles the slab boundary: the
  same loss, and the gradient on exactly the voxels one process keeps,
  which are the ones the JAX package's sort keeps.
- LGA with label edges on the slab boundary: loss and gradient as one
  process's, and the neighbour counts as JAX's.
- The voxel Lovasz term is still refused by name.
- The JAX package's TINY step on a ('data', 'space') mesh of the suite's 8
  virtual CPU devices with CRP3D, the point branch, OHEM, dice and LGA on
  gives its unsharded step's losses: the capability is the reference's.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from stereoscene_tpu.engine.train import LossConfig as JLossConfig
from stereoscene_tpu.engine.train import compute_losses as jcompute
from stereoscene_tpu.losses import local_geometric_anisotropy as jlga
from stereoscene_tpu.losses import ohem_ce_ssc_loss as johem
from stereoscene_tpu.losses.semkitti import class_weights_from_frequencies
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_tpu.parallel.mesh import make_mesh
from stereoscene_tpu.parallel.spatial import shard_voxels
from stereoscene_torch.losses import local_geometric_anisotropy
from stereoscene_torch.models.detector import (BEVDepthOccupancy,
                                               DetectorConfig)
from stereoscene_torch.utils.weights import seeded_init_
from tests import torch_ranks
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_spatial import (_close, _labeled, _leaves_off,
                                      _same_ranks, _stats_close)
from tests.test_torch_train import LOSS_CFG

S = 2
CRP = dict(crp3d=True, crp_mega_shape=(1, 1, 1))
POINTS = dict(supervise_points=True)
P_POINTS = 96
CASES = {
    "crp3d": (CRP, dict(loss_crp_weight=1.0)),
    "points": (POINTS, dict(loss_point_ce_weight=1.0,
                            loss_point_lovasz_weight=1.0)),
    "ohem": ({}, dict(voxel_ohem=1.0)),
    "dice": ({}, dict(voxel_dice=1.0)),
    "lga": ({}, dict(voxel_lga=1.0)),
    "all": ({**CRP, **POINTS},
            dict(loss_crp_weight=1.0, loss_point_ce_weight=1.0,
                 loss_point_lovasz_weight=1.0, voxel_ohem=1.0,
                 voxel_dice=1.0, voxel_lga=1.0)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    return DetectorConfig(**{**dataclasses.asdict(TINY), **kw})


def _batch(rng):
    """A TINY batch of one sample with every branch's inputs: labels at 2x
    whose class edges lie on the slab boundary (X = 8 of 16), relation
    labels for CRP3D's 2x2x1 stage grid, and points around the boundary."""
    batch = _labeled(TINY, 1, rng)
    gt = batch["gt_occ"]
    gt[0, 4:8, 2:10, :4] = 3
    gt[0, 8:12, 2:10, :4] = 9
    gt[0, 7:9, 10:14] = 255
    batch["cp_mega_matrix"] = (rng.rand(1, 4, 4, 1) < 0.4).astype(np.float32)
    xyz = rng.uniform([-0.5, -4.5, -2.5], [8.5, 4.5, 2.5], (P_POINTS, 3))
    xyz[:24, 0] = rng.uniform(3.0, 5.0, 24)  # the slab boundary, x = 4
    labels = rng.randint(0, 20, (P_POINTS, 1))
    batch["points_occ"] = np.concatenate([xyz, labels], 1)[None].astype(
        np.float32)
    batch["points_uv"] = rng.uniform(-1, 1, (1, P_POINTS, 3)).astype(
        np.float32)
    batch["points_count"] = np.array([P_POINTS - 10], np.int32)
    return batch


def _units():
    """The loss-level cases: (loss function, logits [1, X, Y, Z, C],
    labels, keywords)."""
    rng = np.random.RandomState(11)
    # every voxel the same logits: the per-voxel loss takes one value a
    # class; 64 voxels of class 1 (the higher loss) on the even X planes
    # and 64 of class 2 on the odd ones; top_k 0.8125 keeps 104, a tie of
    # 64 at the threshold of which the 40 of highest flat index stay:
    # planes 7 and 5 and the upper half of plane 3, on both slabs
    logits = np.broadcast_to(np.array([0.0, -5.0, 2.0, 0.0, 0.0]),
                             (1, 8, 4, 4, 5))
    labels = np.full((1, 8, 4, 4), 2, np.int32)
    labels[:, ::2] = 1
    lga_logits = rng.randn(1, 8, 4, 4, 5).astype(np.float32)
    lga_labels = rng.randint(0, 5, (1, 8, 4, 4)).astype(np.int32)
    lga_labels[:, 2:4, :2] = 1
    lga_labels[:, 4:6, :2] = 2
    lga_labels[:, 3:5, 3] = 255
    return {"ohem_tie": ("ohem_ce_ssc_loss",
                         np.ascontiguousarray(logits, np.float32), labels,
                         dict(top_k=0.8125)),
            "lga_edge": ("position_aware_loss", lga_logits, lga_labels, {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(8)
    batch = _batch(rng)
    cases, weights = {}, {}
    for name, (model_kw, loss_kw) in CASES.items():
        cfg = _cfg(**model_kw)
        key = tuple(sorted(model_kw))
        if key not in weights:
            model = BEVDepthOccupancy(cfg, device="cpu")
            seeded_init_(model, 7)
            weights[key] = {k: v.clone() for k, v in
                            model.state_dict().items()}
        cases[name] = (cfg, weights[key], batch, dict(LOSS_CFG, **loss_kw))
    units = _units()
    sharded = {}

    def spawn():
        sharded["ranks"] = torch_ranks.run_ranks(
            torch_ranks.spatial_branches, S,
            tmp_path_factory.mktemp("branches"), cases, units)

    thread = threading.Thread(target=spawn)
    thread.start()
    one = torch_ranks.spatial_branches(0, 1, None, cases, units)
    thread.join()
    return sharded["ranks"], one, units


@pytest.mark.parametrize("case", list(CASES))
def test_branch_step_matches_one_process(runs, case):
    ranks, one, _ = runs
    want = one[case]
    terms = want["logs"][0]
    for name in CASES[case][1]:
        if name.startswith("voxel_"):
            assert f"loss_{name}_0" in terms, name
    if "loss_crp_weight" in CASES[case][1]:
        assert "loss_rel_ce" in terms
    if "loss_point_ce_weight" in CASES[case][1]:
        assert {"loss_point_ce", "loss_point_lovasz"} <= terms.keys()
    for r in (res[case] for res in ranks):
        assert r["logs"][0].keys() == terms.keys()
        for k, v in terms.items():
            np.testing.assert_allclose(r["logs"][0][k], v, rtol=1e-5,
                                       err_msg=k)
        bad = _leaves_off(r["grads"], want["grads"])
        assert not bad, f"{len(bad)} leaves off: {sorted(bad)[:8]}"
        _stats_close(r["state"], want["state"])
        _close(r["logits"], want["logits"], msg="eval logits")
    _same_ranks([res[case] for res in ranks])


def test_branch_gradients_reach_their_modules(runs):
    """The sharded step sends gradient into CRP3D and the point MLP."""
    grads = runs[0][0]["all"]["grads"]
    for prefix in ("img_bev_encoder_backbone.cp_mega_voxels.",
                   "pts_bbox_head.point_occ_mlp."):
        assert any(float(g.abs().max()) > 0 for k, g in grads.items()
                   if k.startswith(prefix)), prefix


def test_ohem_tie_at_the_threshold(runs):
    ranks, one, units = runs
    _, logits, labels, kw = units["ohem_tie"]
    want = one["units"]["ohem_tie"]
    got = torch.cat([r["units"]["ohem_tie"]["grad"] for r in ranks], 1)
    for r in ranks:
        np.testing.assert_allclose(r["units"]["ohem_tie"]["loss"],
                                   want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want["grad"].numpy(), rtol=1e-6,
                               atol=1e-9)
    kept = got.abs().sum(-1) > 0
    assert int(kept.sum()) == 104
    # all of class 1, and of the tied class 2 planes 7 and 5 (rank 1) and
    # the 8 voxels of highest index in plane 3 (rank 0)
    assert bool(kept[0, ::2].all()) and bool(kept[0, 5::2].all())
    assert not bool(kept[0, 1].any())
    assert bool(kept[0, 3, 2:].all()) and not bool(kept[0, 3, :2].any())
    # the JAX package's sort keeps the same voxels
    jgrad = jax.grad(lambda x: johem(
        x, jnp.asarray(labels), class_weights_from_frequencies(),
        kw["top_k"]))(jnp.asarray(logits))
    np.testing.assert_array_equal(np.abs(np.asarray(jgrad)).sum(-1) > 0,
                                  kept.numpy())


def test_lga_across_the_slab_boundary(runs):
    ranks, one, units = runs
    _, _, labels, _ = units["lga_edge"]
    want = one["units"]["lga_edge"]
    for r in ranks:
        np.testing.assert_allclose(r["units"]["lga_edge"]["loss"],
                                   want["loss"], rtol=1e-6)
    _close(torch.cat([r["units"]["lga_edge"]["grad"] for r in ranks], 1),
           want["grad"], tol=1e-6)
    counts = local_geometric_anisotropy(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(counts, np.asarray(jlga(
        jnp.asarray(labels))))
    assert counts[0, 3, 0, 0] > 0 and counts[0, 4, 0, 0] > 0


def test_voxel_lovasz_is_still_refused(runs):
    for r in runs[0]:
        message = r["refusal"]
        assert "spatial sharding" in message and "voxel_lovasz" in message
        for name in ("voxel_ohem", "voxel_dice", "voxel_lga"):
            assert name not in message


def test_jax_mesh_step_matches_unsharded():
    """The JAX package's own 3D side on a ('data', 'space') mesh, its voxel
    features constrained as its ``voxel_constraint`` does, with CRP3D, the
    point branch, OHEM, dice and LGA on: its losses and their gradient
    equal its unsharded step's. (The image side, which sharding leaves
    replicated, is left out to keep the compile short.)"""
    cfg = JaxConfig(**{**dataclasses.asdict(TINY), **CRP, **POINTS})
    rng = np.random.RandomState(9)
    x, y, z = cfg.grid_shape
    two = [_batch(rng) for _ in range(2)]
    batch = {k: jnp.asarray(np.concatenate([b[k] for b in two]))
             for k in ("gt_occ", "cp_mega_matrix", "points_occ",
                       "points_count")}
    voxels = jnp.asarray(rng.randn(2, x, y, z, cfg.numC_Trans).astype(
        np.float32))
    loss_cfg = JLossConfig(downsample=TINY.downsample, dbound=TINY.dbound,
                           voxel_ohem=1.0, voxel_dice=1.0, voxel_lga=1.0,
                           loss_crp_weight=1.0, loss_point_ce_weight=1.0,
                           loss_point_lovasz_weight=1.0)
    model = JaxModel(cfg=cfg)
    mesh = make_mesh(8, axes=("data", "space"))

    pts = model.apply({}, batch, method=model._normalized_points)

    def step(constrain):
        def loss(params, vox, b, pts):
            if constrain:
                vox = shard_voxels(vox, mesh)
            head, crp = model.apply({"params": params}, vox, False, pts,
                                    method=model.bev_encode)
            terms = jcompute({"output_voxels": head["output_voxels"],
                              "output_points": head["output_points"],
                              "crp_logits": crp}, b, loss_cfg)
            return sum(terms.values()), terms
        return jax.value_and_grad(loss, has_aux=True)

    params = model.init(jax.random.PRNGKey(0), voxels, False, pts,
                        method=model.bev_encode)["params"]
    (_, want), want_g = jax.jit(step(False))(params, voxels, batch, pts)
    repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    (_, got), got_g = jax.jit(
        step(True), in_shardings=(repl, rows, rows, rows))(
        jax.device_put(params, repl), jax.device_put(voxels, rows),
        jax.device_put(batch, rows), jax.device_put(pts, rows))
    names = {"loss_voxel_ohem_0", "loss_voxel_dice_0", "loss_voxel_lga_0",
             "loss_rel_ce", "loss_point_ce", "loss_point_lovasz"}
    assert names <= set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    leaves = jax.tree_util.tree_leaves_with_path(want_g)
    got_leaves = dict((jax.tree_util.keystr(k), v) for k, v in
                      jax.tree_util.tree_leaves_with_path(got_g))
    scale = max(float(np.abs(np.asarray(v)).max()) for _, v in leaves)
    for k, v in leaves:
        a, b = np.asarray(got_leaves[jax.tree_util.keystr(k)]), np.asarray(v)
        leaf = max(float(np.abs(b).max()), 1e-6)
        assert np.abs(a - b).max() <= max(2e-2 * leaf, 1e-4 * scale), \
            jax.tree_util.keystr(k)
