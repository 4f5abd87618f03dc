"""Geometry and splat plans of the PyTorch port against the JAX package.

Voxel ranks must be integer-identical (they decide which voxel every
frustum point lands in) and the numpy plan builder must give the same
arrays; float geometry agrees within 1e-5.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu import geometry as jgeo
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_tpu.ops import splat_plan as jplan
from stereoscene_torch import geometry as tgeo
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.ops import splat_plan as tplan
from tests.test_models import TINY, _tiny_batch

GEO_KEYS = ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")


def port_cfg(cfg):
    return DetectorConfig(**dataclasses.asdict(cfg))


def _augmented_batch():
    """A batch with a non-identity image augmentation and bda."""
    batch = {k: np.asarray(v) for k, v in _tiny_batch(b=2).items()}
    rng = np.random.RandomState(5)
    post_rots = np.broadcast_to(np.eye(3, dtype=np.float32), (2, 2, 3, 3))
    post_rots = post_rots.copy()
    post_rots[..., :2, :2] *= 0.9
    batch["post_rots"] = post_rots
    batch["post_trans"] = rng.randn(2, 2, 3).astype(np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    bda = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    batch["bda"] = np.broadcast_to(bda, (2, 3, 3)).copy()
    batch["trans"] = rng.randn(2, 2, 3).astype(np.float32) * 0.3
    return batch


def _np_batch(b=1):
    return {k: np.asarray(v) for k, v in _tiny_batch(b=b).items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_ranks(cfg, batch):
    model = JaxModel(cfg=cfg)
    fn = jax.jit(lambda b: model.apply({}, b, method="compute_ranks"))
    return np.asarray(fn({k: jnp.asarray(batch[k]) for k in GEO_KEYS}))


def _flagship_batch():
    from bench import make_flagship_batch

    batch = make_flagship_batch(JaxConfig(), b=1, dtype=jnp.float32)
    return {k: np.asarray(v) for k, v in batch.items() if k != "imgs"}


def test_frustum_matches_jax():
    want = jgeo.create_frustum(TINY.input_size, TINY.downsample, TINY.dbound)
    got = tgeo.create_frustum(TINY.input_size, TINY.downsample, TINY.dbound)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(tgeo.gen_dx_bx(TINY.xbound, TINY.ybound, TINY.zbound),
                    jgeo.gen_dx_bx(TINY.xbound, TINY.ybound, TINY.zbound)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("augmented", [False, True])
def test_geometry_matches_jax(augmented):
    batch = _augmented_batch() if augmented else _np_batch(b=2)
    frustum = jgeo.create_frustum(TINY.input_size, TINY.downsample,
                                  TINY.dbound)
    want = jgeo.get_geometry(jnp.asarray(frustum),
                             *(jnp.asarray(batch[k]) for k in GEO_KEYS))
    got = tgeo.get_geometry(torch.from_numpy(frustum),
                            *(torch.from_numpy(batch[k]) for k in GEO_KEYS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mlp_input_and_disparity_positions_match_jax():
    batch = _augmented_batch()
    want = jgeo.get_mlp_input(*(jnp.asarray(batch[k]) for k in GEO_KEYS))
    got = tgeo.get_mlp_input(*(torch.from_numpy(batch[k]) for k in GEO_KEYS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    calib = np.array([707.0 * 0.54, 20.0], np.float32)
    np.testing.assert_array_equal(
        tgeo.disparity_positions(torch.from_numpy(calib), 112).numpy(),
        np.asarray(jgeo.disparity_positions(jnp.asarray(calib), 112)))


@pytest.mark.parametrize("augmented", [False, True])
def test_ranks_identical_tiny(augmented):
    batch = _augmented_batch() if augmented else _np_batch(b=2)
    want = _jax_ranks(TINY, batch)
    got = BEVDepthOccupancy(port_cfg(TINY), device="cpu").compute_ranks(
        _torch(batch))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want < np.prod(TINY.grid_shape)).sum() < want.size


def test_flagship_plan_identical():
    """The bench calibration at the flagship grid: the port's ranks, group-8
    plan and bounds equal the JAX package's: 496,736 group-padded rows
    in a 547,840-row plan budget."""
    cfg = JaxConfig()
    batch = _flagship_batch()
    nvox = int(np.prod(cfg.grid_shape))
    want = _jax_ranks(cfg, batch)[0]
    model = BEVDepthOccupancy(DetectorConfig(), device="cpu")
    got = model.compute_ranks(_torch(batch))[0].numpy()
    np.testing.assert_array_equal(got, want)
    order, rs = tplan.build_plan(got, nvox, group=8)
    j_order, j_rs = jplan.build_plan(want, nvox, group=8)
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(rs, j_rs)
    assert int((rs < nvox).sum()) == 496_736
    assert len(order) == 547_840


def _random_ranks(seed, p=600, nvox=256):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(p) < 0.4, rng.randint(0, nvox, p),
                    nvox).astype(np.int32), nvox


@pytest.mark.parametrize("group", [1, 8])
def test_build_plan_identical(group):
    ranks, nvox = _random_ranks(0)
    got = tplan.build_plan(ranks, nvox, group=group)
    want = jplan.build_plan(ranks, nvox, group=group)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fixed = tplan.build_plan(ranks, nvox, p_pad=len(want[0]) + 1024,
                             group=group)
    np.testing.assert_array_equal(
        fixed[0], jplan.build_plan(ranks, nvox, len(want[0]) + 1024,
                                   group=group)[0])


@pytest.mark.parametrize("group", [1, 8])
def test_plan_bounds_identical(group):
    ranks, nvox = _random_ranks(1)
    _, rs = tplan.build_plan(ranks, nvox, group=group)
    np.testing.assert_array_equal(
        tplan.plan_bounds(rs, nvox, group), jplan.plan_bounds(rs, nvox, group))


def test_plan_validation_matches_jax():
    ranks, nvox = _random_ranks(2)
    _, rs1 = tplan.build_plan(ranks, nvox, group=1)
    for mod in (tplan, jplan):
        with pytest.raises(ValueError, match="not group-8 aligned"):
            mod.validate_plan_group(rs1[:len(rs1) // 8 * 8], 8)
        with pytest.raises(ValueError):
            mod.build_plan(ranks, nvox, group=3)
        with pytest.raises(ValueError, match="budget too small"):
            mod.build_plan(ranks, nvox, p_pad=8, group=8)
    assert tplan.plan_budget(418_000) == jplan.plan_budget(418_000)


def test_plan_cache_reuses_calibration():
    model = BEVDepthOccupancy(port_cfg(TINY), device="cpu")
    batch = _torch(_np_batch(b=2))
    out = model.plan_cache.attach(batch)
    assert model.plan_cache.misses == 1 and model.plan_cache.hits == 1
    ranks = model.compute_ranks(batch)[0].numpy()
    order, rs = tplan.build_plan(ranks, int(np.prod(TINY.grid_shape)),
                                 group=TINY.splat_group)
    np.testing.assert_array_equal(out["splat_order"][1].numpy(), order)
    np.testing.assert_array_equal(out["splat_ranks"][0].numpy(), rs)
    assert out["splat_bounds"].shape == (2, int(np.prod(TINY.grid_shape)) + 1)


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, imports without
    pulling in JAX, flax or the JAX package; the evaluation path's modules
    are named, so none is skipped."""
    named = ["stereoscene_torch." + m for m in (
        "metrics", "config", "data.labels", "data.semantic_kitti",
        "data.pipeline", "data.loader", "engine.eval", "engine.loop",
        "tools.test", "ops.deform_conv", "ops.gather")]
    code = (
        "import importlib, pkgutil, sys, stereoscene_torch, chip_smoke; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
        "stereoscene_torch.__path__, 'stereoscene_torch.')]; "
        f"[importlib.import_module(m) for m in {named!r}]; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('stereoscene_tpu') or m == 'flax']; "
        "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
