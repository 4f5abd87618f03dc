"""``bev_with_cp`` (the detector's checkpointed view transformer, voxel
encoder and neck) at TINY: a training step with it against one without
it and against the JAX package's step with it.

With and without, on the port (fp32, one seeded generator): the same
loss and gradients (rtol 1e-6, gradients within 1e-5 of the global
scale: the recompute runs the same ops), the BatchNorm statistics
updated once (equal to the step without it), and the ASPP dropout mask
drawn once, before the region, and used by the forward and the
recompute alike.

Against JAX (both sides take the same ASPP mask from numpy, as
tests/test_torch_train.py does): loss terms rtol 2e-3, BatchNorm
statistics within 1e-4 of scale, and the gradient leaves of the voxel
side (encoder, neck, head: the checkpointed ResNet3D and FPN3D and
what follows them) within 2% of the leaf, atol floor 1e-4 x the global
scale. The view transformer's leaves are held submodule by submodule in
tests/test_torch_train.py: the whole detector's gradient at TINY has
kinks within reach of fp32 rounding there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.engine import train as jtrain
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_torch.engine import train as ttrain
from stereoscene_torch.models import depth_net, layers
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.utils.weights import flax_trees, seeded_init_
from tests.test_models import TINY
from tests.test_torch_train import (
    ASPP_SHAPE,
    LOSS_CFG,
    _aspp_mask_patch,
    _flat,
    _labeled_batch,
    _torch_batch,
)

VOXEL_SIDE = ("img_bev_encoder_backbone", "img_bev_encoder_neck",
              "pts_bbox_head")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(bev_with_cp, seed=7):
    cfg = dataclasses.replace(DetectorConfig(**dataclasses.asdict(TINY)),
                              bev_with_cp=bev_with_cp)
    model = BEVDepthOccupancy(cfg, device="cpu")
    seeded_init_(model, seed)
    return model


def _step(model, batch, generator=None):
    state = ttrain.create_train_state(model, device="cpu")
    total, losses, grads = ttrain.loss_and_grads(
        state, batch, ttrain.LossConfig(**LOSS_CFG), generator=generator)
    return total, losses, dict(zip([n for n, _ in state.trainable], grads))


@pytest.fixture(scope="module")
def both():
    """The port's step with and without ``bev_with_cp`` from one seed,
    recording the ASPP masks drawn and the masks each dropout used."""
    batch = _torch_batch(_labeled_batch(np.random.RandomState(11)))
    runs = {}
    for cp in (False, True):
        drawn, used = [], []
        draw, drop = layers.keep_mask, depth_net.dropout

        def keep_mask(*a, **kw):
            mask = draw(*a, **kw)
            drawn.append(mask.clone())
            return mask

        def dropout(x, rate, generator=None, mask=None):
            used.append(None if mask is None else mask.clone())
            return drop(x, rate, generator, mask)

        model = _model(cp)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "keep_mask", keep_mask)
            mp.setattr(depth_net, "dropout", dropout)
            total, losses, grads = _step(
                model, batch, torch.Generator().manual_seed(3))
        runs[cp] = dict(total=total, losses=losses, grads=grads,
                        state=model.state_dict(), drawn=drawn, used=used)
    runs["init"] = _model(False).state_dict()
    return runs


def test_loss_and_gradients_equal_without_it(both):
    off, on = both[False], both[True]
    assert on["losses"].keys() == off["losses"].keys()
    for key, value in off["losses"].items():
        torch.testing.assert_close(on["losses"][key], value, rtol=1e-6,
                                   atol=0, msg=key)
    scale = max(float(g.abs().max()) for g in off["grads"].values())
    assert scale > 1e-2
    for key, value in off["grads"].items():
        torch.testing.assert_close(on["grads"][key], value, rtol=1e-5,
                                   atol=1e-5 * scale, msg=key)


def test_batch_statistics_updated_once(both):
    off, on, init = both[False]["state"], both[True]["state"], both["init"]
    stats = [k for k in off if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 50
    vt = [k for k in stats if k.startswith("img_view_transformer.")]
    assert vt and all(not torch.equal(off[k], init[k]) for k in vt)
    for key in stats:
        torch.testing.assert_close(on[key], off[key], rtol=1e-6, atol=1e-7,
                                   msg=key)


def test_one_dropout_mask(both):
    """One ASPP mask is drawn in each run, the same one; the checkpointed
    run draws it before its region, and its forward and recompute both
    drop with it."""
    off, on = both[False], both[True]
    assert len(off["drawn"]) == len(on["drawn"]) == 1
    mask = off["drawn"][0]
    assert tuple(mask.shape) == ASPP_SHAPE and 0 < mask.float().mean() < 1
    assert torch.equal(on["drawn"][0], mask)
    assert off["used"] == [None]  # drawn inside the dropout
    assert len(on["used"]) == 2
    assert all(torch.equal(m, mask) for m in on["used"])


@pytest.fixture(scope="module")
def against_jax():
    rng = np.random.RandomState(5)
    batch = _labeled_batch(rng)
    mask = rng.rand(*ASPP_SHAPE) < 0.5
    model = _model(True)
    params, stats = flax_trees(model)
    jm = JaxModel(cfg=dataclasses.replace(TINY, bev_with_cp=True))

    def jloss(p, s, b):
        out, mutated = jm.apply({"params": p, "batch_stats": s}, b,
                                train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        losses = jtrain.compute_losses(out, b, jtrain.LossConfig(**LOSS_CFG))
        return sum(losses.values()), (losses, mutated["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        _aspp_mask_patch(mp, mask)
        (_, (jlosses, jstats)), jgrads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
        _, losses, grads = _step(model, _torch_batch(batch))
    tgrads, tstats = flax_trees(model, grads)
    return dict(jlosses=jlosses, jstats=_flat(jstats), jgrads=jgrads,
                losses=losses, tstats=_flat(tstats), tgrads=tgrads,
                stats0=_flat(stats))


def test_loss_terms_and_statistics_match_jax(against_jax):
    got, want = against_jax["losses"], against_jax["jlosses"]
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_allclose(float(value), float(want[key]), rtol=2e-3,
                                   err_msg=key)
    jstats, tstats = against_jax["jstats"], against_jax["tstats"]
    assert jstats.keys() == tstats.keys()
    for key, value in jstats.items():
        assert not np.array_equal(value, against_jax["stats0"][key]), key
        np.testing.assert_allclose(tstats[key], value, rtol=1e-4,
                                   atol=1e-4 * np.abs(value).max(),
                                   err_msg=key)


def test_voxel_side_gradients_match_jax(against_jax):
    jg = {k: v for k, v in _flat(against_jax["jgrads"]).items()
          if k.startswith(VOXEL_SIDE)}
    tg = {k: v for k, v in _flat(against_jax["tgrads"]).items()
          if k.startswith(VOXEL_SIDE)}
    assert jg.keys() == tg.keys() and len(jg) > 30
    scale = max(max(np.abs(g).max() for g in jg.values()),
                max(np.abs(g).max() for g in tg.values()))
    assert scale > 1e-3
    bad = []
    for key, want in jg.items():
        leaf = max(np.abs(want).max(), np.abs(tg[key]).max(), 1e-6)
        err = np.abs(tg[key] - want).max()
        if err > max(2e-2 * leaf, 1e-4 * scale):
            bad.append((key, float(err / leaf)))
    assert not bad, bad[:8]
