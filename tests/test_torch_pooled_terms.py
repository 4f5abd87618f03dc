"""Every optional loss term of ``engine.train.compute_losses`` pooled over
two gloo ranks equals one process on the global batch, and the JAX
package's ``compute_losses`` on it.

Each rank computes the terms on its half of a global batch of model
outputs and labels (OHEM, Lovasz, dice, LGA, the KL depth loss, the imgseg
CE, the CRP relation loss, the point CE and Lovasz; then the streaming
ce / sem_scal / geo_scal triple). A term that divides by a count must
divide by the global count, and Lovasz must sort the global batch's
errors: each rank's value must equal the one-process value (rtol 1e-5),
and its input gradients, which carry W times its share as in the train
step, divided by W must equal its rows of the one-process gradients
(within 1e-5 of their scale). The one-process values are held to JAX's
(rtol 1e-5).

The ranks are spawned processes (tests/torch_ranks.py); this module
imports JAX only inside the test that needs it, so they start without it.
"""

import numpy as np
import torch

from stereoscene_torch.engine import train
from tests.torch_ranks import run_ranks

W = 2
B = 4  # the global batch
GRID = (4, 4, 2)
TERMS = dict(voxel_ohem=1.0, voxel_lovasz=1.0, voxel_dice=1.0,
             voxel_lga=1.0, loss_depth_type="kld", loss_seg_weight=1.0,
             loss_crp_weight=1.0, loss_point_ce_weight=1.0,
             loss_point_lovasz_weight=1.0, downsample=4,
             dbound=(2.0, 10.0, 0.5))
STREAM = dict(stream_voxel_chunks=2, downsample=4, dbound=(2.0, 10.0, 0.5))
OUTPUTS = ("output_voxels", "depth_prob", "imgseg_logits", "crp_logits",
           "output_points")


def _global_batch():
    """Model outputs and labels of a global batch of B samples (numpy)."""
    rng = np.random.RandomState(0)
    x, y, z = GRID
    gt = rng.randint(0, 20, (B, 2 * x, 2 * y, 2 * z))
    gt[rng.rand(*gt.shape) < 0.1] = 255
    dp = rng.rand(B, 16, 8, 16).astype(np.float32) + 0.1
    points = np.concatenate([rng.uniform(-8, 8, (B, 30, 3)),
                             rng.randint(0, 6, (B, 30, 1))], -1)
    return {
        "output_voxels": (rng.randn(B, x, y, z, 20) * 2).astype(np.float32),
        "depth_prob": dp / dp.sum(1, keepdims=True),
        "imgseg_logits": rng.randn(B, 8, 16, 20).astype(np.float32),
        "crp_logits": rng.randn(B, 4, 32, 4).astype(np.float32),
        "output_points": rng.randn(B, 30, 20).astype(np.float32),
        "gt_occ": gt.astype(np.int32),
        "gt_depth": ((rng.rand(B, 2, 32, 64) < 0.3)
                     * rng.uniform(1.5, 11.0, (B, 2, 32, 64))).astype(
                         np.float32),
        "img_seg": rng.randint(0, 20, (B, 2, 32, 64)).astype(np.float32),
        "cp_mega_matrix": (rng.rand(B, 4, 32, 4) < 0.3).astype(np.uint8),
        "points_occ": points.astype(np.float32),
        "points_count": np.array([30, 22, 25, 9], np.int32),
    }


def _terms(rank, world, url, data):
    """Every term's value and the gradients of its outputs, on this rank's
    rows."""
    b = B // world
    rows = {k: torch.from_numpy(v[rank * b:(rank + 1) * b].copy())
            for k, v in data.items()}
    out = {}
    for kw in (TERMS, STREAM):
        outputs = {k: rows[k].requires_grad_() for k in OUTPUTS}
        losses = train.compute_losses(outputs, rows, train.LossConfig(**kw))
        for name, value in losses.items():
            grads = torch.autograd.grad(value, [outputs[k] for k in OUTPUTS],
                                        retain_graph=True, allow_unused=True)
            out[name] = (float(value.detach()),
                         {k: g for k, g in zip(OUTPUTS, grads)
                          if g is not None})
    return out


def _jax_terms(data):
    """The JAX package's terms. Its ``compute_losses`` cannot give the
    voxel Lovasz term: the function imports ``lovasz_softmax`` locally in
    its point branch, which makes the name local to the whole function, so
    ``voxel_lovasz > 0`` raises UnboundLocalError there. That term is
    computed as ``compute_losses`` would: the JAX ``lovasz_softmax`` on the
    softmax of the upsampled logits."""
    import jax
    import jax.numpy as jnp

    from stereoscene_tpu.engine import train as jtrain
    from stereoscene_tpu.losses.lovasz import lovasz_softmax
    from stereoscene_tpu.ops.resize import resize_trilinear

    out = {}
    for kw in (dict(TERMS, voxel_lovasz=0.0), STREAM):
        outputs = {k: jnp.asarray(data[k]) for k in OUTPUTS}
        outputs["output_voxels"] = [outputs["output_voxels"]]
        losses = jtrain.compute_losses(
            outputs, {k: jnp.asarray(v) for k, v in data.items()},
            jtrain.LossConfig(**kw))
        out.update({k: float(v) for k, v in losses.items()})
    gt = jnp.asarray(data["gt_occ"])
    up = resize_trilinear(jnp.asarray(data["output_voxels"]), gt.shape[1:4])
    out["loss_voxel_lovasz_0"] = float(lovasz_softmax(
        jax.nn.softmax(up, axis=-1), gt, ignore=255))
    return out


def test_new_terms_pool_over_ranks_as_one_process_and_jax(tmp_path):
    data = _global_batch()
    one = _terms(0, 1, None, data)
    assert set(one) == {
        "loss_voxel_ce_0", "loss_voxel_sem_scal_0", "loss_voxel_geo_scal_0",
        "loss_voxel_ohem_0", "loss_voxel_lovasz_0", "loss_voxel_dice_0",
        "loss_voxel_lga_0", "loss_depth", "loss_imgseg", "loss_rel_ce",
        "loss_point_ce", "loss_point_lovasz"}
    want = _jax_terms(data)
    assert set(want) == set(one)
    for name, value in want.items():
        np.testing.assert_allclose(one[name][0], value, rtol=1e-5,
                                   err_msg=name)
    ranks = run_ranks(_terms, W, tmp_path, data)
    b = B // W
    for r, got in enumerate(ranks):
        assert set(got) == set(one)
        for name, (value, grads) in got.items():
            np.testing.assert_allclose(value, one[name][0], rtol=1e-5,
                                       err_msg=name)
            assert grads.keys() == one[name][1].keys()
            for key, g in grads.items():
                full = one[name][1][key].numpy()
                scale = np.abs(full).max()
                assert scale > 0, (name, key)
                np.testing.assert_allclose(
                    g.numpy() / W, full[r * b:(r + 1) * b], rtol=0,
                    atol=1e-5 * scale, err_msg=f"{name} d{key}")
