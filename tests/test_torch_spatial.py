"""Spatial sharding of the voxel grid (``stereoscene_torch.parallel.spatial``)
on gloo CPU ranks at TINY, against the port in one process and the JAX
package's unsharded forward: the port's counterpart of
tests/test_spatial_consistency.py.

The ranks run in spawned processes (tests/torch_ranks.py, no JAX there),
each on its X slab of the same seeded numpy inputs.

- The halo exchange under a sharded ``Conv3d`` (3x3x3 stride 1 padding 1,
  stride 2, and K4's gated conv through its plain version on the CPU),
  the sharded ``GroupNorm`` and the replicate-edge halo of the losses'
  resize: the slabs' outputs and input gradients joined, and the weight
  gradients summed over the ranks, within 1e-5 of each tensor's scale of
  the unsharded module's; the same through the all_reduce route that gloo
  takes for CUDA tensors; ``gather_slabs`` exact.
- The TINY detector at (data 1, space 2), streaming losses over 2 Y-slabs:
  the eval forward within 1e-5 of max|ref| of one process and within
  2e-3 of max|ref| of JAX's unsharded forward on the same weights; a train
  step's losses within 1e-5 relative, every gradient leaf within
  max(2e-2 * leaf scale, 1e-4 * global scale), the running statistics
  within 1e-5 of scale, both ranks' parameters bitwise equal.
- At (data 2, space 2) on a TINY variant with X = 16 and ``bev_with_cp``
  (whose recompute exchanges the halos and pools the GroupNorm and
  BatchNorm statistics again), the full-upsample losses: the eval forward
  within 1e-5 of max|ref| and the losses within 1e-5 relative of one
  process at B = 2 (so too the plain data-parallel step), and the
  running statistics within 1e-5 of scale; every gradient leaf within
  max(2e-2 * leaf, 1e-4 * global) of the plain data-parallel step at
  (data 2, space 1), which computes the image side with the same pooled
  BatchNorm arithmetic, and its running statistics exactly. Against one
  process the whole gradient is held within 2.5e-2 of the global scale,
  as tests/test_torch_ddp.py holds the data-parallel step: the pooled
  two-pass BatchNorm statistics move a few leaves of the image side past
  2% (the kinks of the TINY gradient, tests/test_torch_train.py), and the
  data-parallel step moves the same leaves by the same amounts.
- The refusals, by name: an X that does not divide, the voxel Lovasz
  term (with OHEM on beside it, which runs sharded), a conv without a halo
  rule. CRP3D, the point branch and the OHEM, dice and LGA terms run on
  the sharded grid (tests/test_torch_spatial_branches.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_torch.models.detector import DetectorConfig
from stereoscene_torch.utils.weights import flax_trees
from tests import torch_ranks
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import port_model
from tests.test_torch_train import LOSS_CFG

S = 2
TINY_X16_CP = DetectorConfig(**dict(dataclasses.asdict(TINY),
                                    xbound=(0.0, 16.0, 1.0),
                                    bev_with_cp=True))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _labeled(cfg, b, rng):
    """A TINY batch of ``b`` samples for ``cfg``'s grid, labels at 2x."""
    batch = {k: np.array(v) for k, v in _tiny_batch(b=b, rng=rng).items()}
    x, y, z = cfg.grid_shape
    h, w = cfg.input_size
    batch["gt_occ"] = np.where(
        rng.rand(b, 2 * x, 2 * y, 2 * z) < 0.1, 255,
        rng.randint(0, 20, (b, 2 * x, 2 * y, 2 * z))).astype(np.int32)
    batch["gt_depth"] = ((rng.rand(b, 2, h, w) < 0.07)
                         * (rng.rand(b, 2, h, w) * 7.5 + 2.1)
                         ).astype(np.float32)
    return batch


def _unit_data():
    rng = np.random.RandomState(0)

    def n(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    return dict(
        s1_x=n(2, 8, 8, 5, 6), s1_cot=n(2, 6, 8, 5, 6),
        s1_w=dict(weight=n(6, 8, 3, 3, 3, scale=0.2), bias=n(6)),
        s2_x=n(2, 8, 8, 5, 6), s2_cot=n(2, 6, 4, 3, 3),
        s2_w=dict(weight=n(6, 8, 3, 3, 3, scale=0.2)),
        k4_x=n(1, 64, 8, 3, 4), k4_cot=n(1, 64, 8, 3, 4),
        k4_w=dict(weight=n(64, 64, 3, 3, 3, scale=0.05)),
        gn_w=dict(weight=n(8, scale=0.3) + 1.0, bias=n(8)),
        gn_cot=n(2, 8, 8, 5, 6), rep_cot=n(S, 2, 8, 6, 5, 6))


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """(inputs, the two ranks' results, the one process's, the model and
    its batch)."""
    data = _unit_data()
    model = port_model(seed=7)
    batch = _labeled(TINY, 1, np.random.RandomState(5))
    model_args = (model.cfg, {k: v.clone() for k, v in
                              model.state_dict().items()}, batch,
                  dict(LOSS_CFG, stream_voxel_chunks=2))
    ranks = torch_ranks.run_ranks(torch_ranks.spatial_units, S,
                                  tmp_path_factory.mktemp("spatial"), data,
                                  model_args)
    one = torch_ranks.spatial_units(0, 1, None, data, model_args)
    return data, ranks, one, model, batch


def _close(got, want, tol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=msg)


@pytest.mark.parametrize("name", ["s1", "s2", "k4", "s1_reduce", "gn"])
def test_sharded_module_matches_unsharded(units, name):
    _, ranks, one, _, _ = units
    want = one[name.replace("_reduce", "")]
    got = [r[name] for r in ranks]
    _close(torch.cat([g["y"] for g in got], 2), want["y"], msg="y")
    _close(torch.cat([g["gx"] for g in got], 2), want["gx"], msg="gx")
    for g in got:
        for i, (a, b) in enumerate(zip(g["gp"], want["gp"])):
            _close(a, b, msg=f"param grad {i}")
    assert all(r["k4_gate"] for r in ranks)  # the halo keeps K4's gate


def test_replicate_halo_and_gather(units):
    data, ranks, one, _, _ = units
    for r, res in enumerate(ranks):
        assert torch.equal(res["replicate"]["y"], one["replicate"]["y"][r])
        assert torch.equal(res["gathered"], torch.from_numpy(data["s1_x"]))
    _close(torch.cat([res["replicate"]["gx"] for res in ranks], 2),
           one["replicate"]["gx"])


@pytest.mark.parametrize("key, words", [
    ("x", ["X = 12", "2 space shards", "total stride 4"]),
    ("lovasz", ["voxel_lovasz"]),
    ("conv5", ["no halo rule", "(5, 1, 2, 1)"]),
])
def test_refusals_name_what_is_refused(units, key, words):
    for r in units[1]:
        message = r["refusals"][key]
        assert "spatial sharding" in message
        for word in words:
            assert word in message, message
        assert "voxel_ohem" not in message


def test_sharded_forward_matches_one_process_and_jax(units):
    _, ranks, one, model, batch = units
    want = one["model"]["logits"]
    for r in ranks:
        _close(r["model"]["logits"], want, msg="vs one process")
    params, stats = flax_trees(model)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()
              if not k.startswith("gt_")}
    ref = JaxModel(cfg=TINY).apply({"params": params, "batch_stats": stats},
                                   jbatch, train=False)["output_voxels"][0]
    ref = np.asarray(ref)
    err = np.abs(ranks[0]["model"]["logits"].numpy() - ref).max()
    assert err <= 2e-3 * np.abs(ref).max(), err / np.abs(ref).max()


def _leaves_off(got, want, leaf_tol=2e-2, global_tol=1e-4):
    assert got.keys() == want.keys() and len(want) > 300
    scale = max(float(g.abs().max()) for g in want.values())
    assert scale > 1e-2  # a degenerate grad field would hide bugs
    bad = []
    for key, w in want.items():
        leaf = max(float(w.abs().max()), float(got[key].abs().max()), 1e-6)
        err = float((got[key] - w).abs().max())
        if err > max(leaf_tol * leaf, global_tol * scale):
            bad.append((key, err / leaf))
    return bad


def _stats_close(got, want, tol=1e-5):
    keys = [k for k in want if "running" in k]
    assert keys
    for k in keys:
        _close(got[k], want[k], tol=tol, msg=k)


def _same_ranks(ranks):
    a = ranks[0]
    for r in ranks[1:]:
        assert r["logs"] == a["logs"]
        for k, v in a["state"].items():
            assert torch.equal(v, r["state"][k]), k


def test_sharded_step_matches_one_process(units):
    _, ranks, one, _, _ = units
    want = one["model"]
    for r in (res["model"] for res in ranks):
        assert r["logs"][0].keys() == want["logs"][0].keys()
        for k, v in want["logs"][0].items():
            np.testing.assert_allclose(r["logs"][0][k], v, rtol=1e-5,
                                       err_msg=k)
        bad = _leaves_off(r["grads"], want["grads"])
        assert not bad, f"{len(bad)} leaves off: {sorted(bad)[:8]}"
        _stats_close(r["state"], want["state"])
    _same_ranks([res["model"] for res in ranks])


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    """The (2, 2) layout, the plain data-parallel (2, 1) one and one
    process, at B = 2 on the X = 16 variant with ``bev_with_cp``."""
    model = port_model(seed=7)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = _labeled(TINY_X16_CP, 2, np.random.RandomState(6))
    args = (TINY_X16_CP, weights, batch, dict(LOSS_CFG))
    tmp = tmp_path_factory.mktemp("grid4")
    sharded = torch_ranks.run_ranks(torch_ranks.spatial_case, 4, tmp, S,
                                    *args)
    plain = torch_ranks.run_ranks(torch_ranks.spatial_case, 2, tmp, 1, *args)
    one = torch_ranks.spatial_case(0, 1, None, 1, *args)
    return dict(sharded=sharded, plain=plain, one=one, weights=weights)


def test_grid_2x2_matches_one_process(grid4):
    one = grid4["one"]
    for r in grid4["plain"]:
        for k, v in one["logs"][0].items():
            np.testing.assert_allclose(r["logs"][0][k], v, rtol=1e-5,
                                       err_msg=k)
    for i, r in enumerate(grid4["sharded"]):
        _close(r["logits"][0], one["logits"][i // S], msg="eval logits")
        for k, v in one["logs"][0].items():
            np.testing.assert_allclose(r["logs"][0][k], v, rtol=1e-5,
                                       err_msg=k)
        _stats_close(r["state"], one["state"])
        scale = max(float(g.abs().max()) for g in one["grads"].values())
        worst = max(float((r["grads"][k] - g).abs().max())
                    for k, g in one["grads"].items())
        assert worst <= 2.5e-2 * scale, worst / scale


def test_grid_2x2_leaves_match_data_parallel(grid4):
    for i, r in enumerate(grid4["sharded"]):
        plain = grid4["plain"][i // S]
        bad = _leaves_off(r["grads"], plain["grads"])
        assert not bad, f"{len(bad)} leaves off: {sorted(bad)[:8]}"
        for k, v in plain["state"].items():
            if "running" in k:
                assert torch.equal(r["state"][k], v), k


def test_grid_2x2_ranks_stay_bitwise_equal(grid4):
    _same_ranks(grid4["sharded"])
    moved = [k for k, v in grid4["weights"].items()
             if not torch.equal(v, grid4["sharded"][0]["state"][k])]
    assert len(moved) > 300
