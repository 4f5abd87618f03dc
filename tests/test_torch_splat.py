"""The port's lift-splat (the plain versions of kernels K2/K3, which CPU
tensors take) against the JAX package: ``lift_splat_static`` for group-1
and group-8 plans, the Pallas sorted splat and the fused Pallas lift+splat
in interpret mode. 1e-5; 1e-4 where JAX reduces by cumsum-then-difference
(its cancellation error grows with the running sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from stereoscene_tpu.ops import voxel_pool as jpool
from stereoscene_tpu.ops.pallas_splat import _splat_sorted
from stereoscene_tpu.ops.pallas_splat_fused import (
    fused_splat_sorted,
    pallas_lift_splat_fused,
)
from chip_smoke import chunk_partition
from stereoscene_torch.ops import splat_plan as tplan
from stereoscene_torch.ops import voxel_pool as tpool

GRID = (8, 8, 8)  # 512 voxels: one TILE of the Pallas splats
NVOX = 512


def _problem(seed, d=6, fh=4, fw=5, c=8):
    rng = np.random.RandomState(seed)
    p = d * fh * fw
    # ~40% in bounds, like the real frustum; a few hot voxels get long runs
    ranks = np.where(rng.rand(p) < 0.4, rng.randint(0, NVOX, p), NVOX)
    ranks[:20] = 7
    dp = rng.rand(1, d, fh, fw).astype(np.float32)
    feat = rng.randn(1, fh, fw, c).astype(np.float32)
    return ranks.astype(np.int32), dp, feat


def _plan(ranks, group):
    order, rs = tplan.build_plan(ranks, NVOX, group=group)
    return order, rs, tplan.plan_bounds(rs, NVOX, group)


def _port_static(dp, feat, order, rs, bounds, group):
    return tpool.lift_splat_static(
        torch.from_numpy(dp), torch.from_numpy(feat),
        torch.from_numpy(order[None]), torch.from_numpy(rs[None]), GRID,
        group=group,
        bounds=None if bounds is None else torch.from_numpy(bounds[None]),
    ).numpy()


@pytest.mark.parametrize("group", [1, 8])
def test_static_with_bounds_matches_jax(group):
    ranks, dp, feat = _problem(0)
    order, rs, bounds = _plan(ranks, group)
    want = jpool.lift_splat_static(
        jnp.asarray(dp), jnp.asarray(feat), jnp.asarray(order[None]),
        jnp.asarray(rs[None]), GRID, group=group,
        bounds=jnp.asarray(bounds[None]))
    got = _port_static(dp, feat, order, rs, bounds, group)
    assert got.shape == (1,) + GRID + (8,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("group", [1, 8])
def test_static_without_bounds_matches_jax_segment_sum(group):
    ranks, dp, feat = _problem(1)
    order, rs, _ = _plan(ranks, group)
    want = jpool.lift_splat_static(
        jnp.asarray(dp), jnp.asarray(feat), jnp.asarray(order[None]),
        jnp.asarray(rs[None]), GRID, group=group)
    got = _port_static(dp, feat, order, rs, None, group)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fused_matches_pallas_fused_interpret():
    """K3 semantics: group-1 plan against the fused Pallas kernel."""
    ranks, dp, feat = _problem(2)
    want = pallas_lift_splat_fused(
        jnp.asarray(dp), jnp.asarray(feat), jnp.asarray(ranks[None]), GRID,
        interpret=True)
    order, rs, bounds = _plan(ranks, 1)
    got = _port_static(dp, feat, order, rs, bounds, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    got8 = _port_static(dp, feat, *_plan(ranks, 8), 8)
    np.testing.assert_allclose(got8, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_splat_sorted_matches_pallas_interpret():
    """K2 semantics: pre-lifted sorted rows, sentinel-padded."""
    rng = np.random.RandomState(3)
    ranks, _, _ = _problem(3)
    order, rs = tplan.build_plan(ranks, NVOX)
    vals = rng.randn(len(rs), 16).astype(np.float32)
    vals[rs >= NVOX] = 0.0
    want = _splat_sorted(jnp.asarray(vals), jnp.asarray(rs), NVOX, True)
    got = tpool.splat_sorted(torch.from_numpy(vals), torch.from_numpy(rs),
                             NVOX)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_entry_matches_sorted_entry():
    """The two entry points agree: lifting rows then splat_sorted equals
    lift_splat_fused on a group-1 plan."""
    ranks, dp, feat = _problem(4)
    order, rs, bounds = _plan(ranks, 1)
    live = rs < NVOX
    vals = dp.reshape(-1)[order][:, None] * feat.reshape(-1, 8)[
        order % 20] * live[:, None]
    a = tpool.splat_sorted(torch.from_numpy(vals.astype(np.float32)),
                           torch.from_numpy(rs), NVOX)
    b = tpool.lift_splat_fused(
        torch.from_numpy(dp.reshape(-1)), torch.from_numpy(feat.reshape(-1, 8)),
        torch.from_numpy(order), torch.from_numpy(bounds), 1, NVOX)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_static_bf16_tables_are_widened_exactly():
    """bf16 depth and features (serving's dtype) give the output of their
    fp32 copies, as the JAX path's astype(float32) does."""
    ranks, dp, feat = _problem(6)
    order, rs, bounds = _plan(ranks, 8)
    dp16 = torch.from_numpy(dp).bfloat16()
    feat16 = torch.from_numpy(feat).bfloat16()
    args = (torch.from_numpy(order[None]), torch.from_numpy(rs[None]), GRID)
    kw = dict(group=8, bounds=torch.from_numpy(bounds[None]))
    got = tpool.lift_splat_static(dp16, feat16, *args, **kw)
    want = tpool.lift_splat_static(dp16.float(), feat16.float(), *args, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_cpu_tensors_refuse_the_kernel():
    ranks, dp, feat = _problem(5)
    order, rs, bounds = _plan(ranks, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tpool.lift_splat_fused(
            torch.from_numpy(dp.reshape(-1)),
            torch.from_numpy(feat.reshape(-1, 8)), torch.from_numpy(order),
            torch.from_numpy(bounds), 8, NVOX, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tpool.splat_sorted(torch.zeros(len(rs), 4), torch.from_numpy(rs),
                           NVOX, use_kernel=True)


# ---- the chunked kernel's partition (csrc/splat.cu), modelled in torch ----
#
# The CUDA kernel gives each warp a run of ``chunk_rows`` plan rows, writes
# the voxels that lie wholly in its run, leaves a head / tail partial for a
# voxel crossing the run's start / end, and a fix-up adds the partials in
# chunk order and zeroes empty voxels. ``_kernel_model`` follows those
# steps (per chunk, then per voxel) and counts the writes of each voxel.

def _kernel_model(vals, bounds, group, chunk_rows):
    """vals [rows, C] plan rows (pads zero); bounds [NVOX + 1] over the
    group-reduced rows -> [NVOX, C], asserting that every voxel is written
    exactly once and every partial the fix-up reads was written."""
    vals = torch.as_tensor(vals)
    nv, c, rows = len(bounds) - 1, vals.shape[1], vals.shape[0]
    row_b = np.asarray(bounds, np.int64) * group
    n_chunks = -(-rows // chunk_rows)
    out = torch.full((nv, c), float("nan"))
    partials = torch.full((n_chunks, 2, c), float("nan"))
    writes = np.zeros(nv, np.int64)
    by_chunk = []
    for chunk in range(n_chunks):
        s, e = chunk * chunk_rows, (chunk + 1) * chunk_rows
        r_lo, r_hi = max(s, row_b[0]), min(e, row_b[nv])
        if r_lo >= r_hi:
            continue
        v = int(np.searchsorted(bounds, r_lo // group, side="right")) - 1
        while True:
            lo, hi = max(row_b[v], r_lo), min(row_b[v + 1], r_hi)
            acc = vals[lo:hi].sum(0)
            if row_b[v] >= s and row_b[v + 1] <= e:
                out[v] = acc
                writes[v] += 1
                by_chunk.append(v)
            else:
                partials[chunk, 0 if row_b[v] < s else 1] = acc
            if hi >= r_hi:
                break
            v += 1
            while row_b[v + 1] <= hi:  # skip empty voxels
                v += 1
    for v in range(nv):  # the fix-up launch
        b, e = row_b[v], row_b[v + 1]
        if b >= e:
            out[v] = 0.0
            writes[v] += 1
            continue
        cb, ce = b // chunk_rows, (e - 1) // chunk_rows
        if cb == ce:
            continue
        acc = partials[cb, 1].clone()
        for k in range(cb + 1, ce + 1):
            acc = acc + partials[k, 0]
        out[v] = acc
        writes[v] += 1
    assert (writes == 1).all() and not torch.isnan(out).any()
    part = chunk_partition(bounds, group, rows, chunk_rows)
    assert sorted(by_chunk) == list(np.nonzero(part["direct"])[0])
    assert part["n_chunks"] == n_chunks
    return out.numpy()


def _lifted_rows(dp, feat, order):
    """The kernel's plan rows: dp[o] * feat[o % HW], zero where o >= P."""
    table = feat.reshape(-1, feat.shape[-1])
    live = order < dp.size
    o = np.where(live, order, 0)
    return ((dp.reshape(-1)[o] * live)[:, None]
            * table[o % len(table)]).astype(np.float32)


def _adversarial_ranks(kind, p):
    """Rank arrays [P] (NVOX = out of bounds) that stress the partition."""
    rng = np.random.RandomState(11)
    if kind == "long":  # the flagship's longest voxel: 1,360 rows
        ranks = np.where(rng.rand(p) < 0.3, rng.randint(0, NVOX, p), NVOX)
        ranks[rng.permutation(p)[:1360]] = 7
    elif kind == "one voxel":
        ranks = np.full(p, 300)
    elif kind == "none":
        ranks = np.full(p, NVOX)
    elif kind == "last voxel":
        ranks = np.where(rng.rand(p) < 0.5, NVOX - 1, NVOX)
    else:  # "random": ~40% in bounds, voxel 7 hot
        ranks = np.where(rng.rand(p) < 0.4, rng.randint(0, NVOX, p), NVOX)
        ranks[:20] = 7
    return ranks.astype(np.int32)


def _adversarial_problem(kind, c, seed=0):
    d, fh, fw = 8, 12, 16  # P = 1536 points, room for a 1,360-row voxel
    rng = np.random.RandomState(seed)
    dp = rng.rand(1, d, fh, fw).astype(np.float32)
    feat = rng.randn(1, fh, fw, c).astype(np.float32)
    return _adversarial_ranks(kind, d * fh * fw), dp, feat


def _close(got, want):
    scale = float(np.abs(want).max(initial=0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


PLANS = ["long", "one voxel", "none", "last voxel", "random"]


@pytest.mark.parametrize("c", [128, 96, 40])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("kind", PLANS)
def test_chunk_model_matches_jax_segment_sum(kind, group, c):
    """K3's partition, chunks of 32 rows (a 1,360-row voxel spans 43),
    against the JAX package's segment_sum_bounds on the grouped plan."""
    ranks, dp, feat = _adversarial_problem(kind, c)
    order, rs, bounds = _plan(ranks, group)
    rows = _lifted_rows(dp, feat, order)
    got = _kernel_model(rows, bounds, group, 32)
    want = jpool.segment_sum_bounds(
        jnp.asarray(rows.reshape(-1, group, c).sum(1)),
        jnp.asarray(rs[::group]), jnp.asarray(bounds), NVOX)
    _close(got, np.asarray(want))
    if kind == "none":
        assert not got.any()


@pytest.mark.parametrize("chunk_rows", [tpool.CHUNK_ROWS, 1024])
@pytest.mark.parametrize("kind", PLANS)
def test_chunk_model_matches_pallas_fused_interpret(kind, chunk_rows):
    """The group-8 partition at the kernel's chunk size (and one chunk
    larger than the longest voxel) against the fused Pallas kernel in
    interpret mode on the group-1 plan of the same points."""
    c = (128, 96, 40)[PLANS.index(kind) % 3]
    ranks, dp, feat = _adversarial_problem(kind, c, seed=1)
    order1, rs1, _ = _plan(ranks, 1)
    want = fused_splat_sorted(
        jnp.asarray(dp.reshape(-1, 1)), jnp.asarray(feat.reshape(-1, c)),
        jnp.asarray(order1), jnp.asarray(rs1), NVOX, interpret=True)
    order, rs, bounds = _plan(ranks, 8)
    got = _kernel_model(_lifted_rows(dp, feat, order), bounds, 8, chunk_rows)
    _close(got, np.asarray(want))
    part = chunk_partition(bounds, 8, len(order), chunk_rows)
    if kind == "long":
        assert part["longest"] >= 1360
    if kind == "long" and chunk_rows < 1024:  # one voxel over 10 chunks
        assert (part["last"] - part["first"]).max() >= 10


@pytest.mark.parametrize("kind", ["long", "last voxel", "random"])
def test_sorted_chunk_model_matches_pallas_splat_interpret(kind):
    """K2: the bounds the kernel derives from the sorted ranks (searchsorted,
    left side) and its partition, against the Pallas sorted splat."""
    ranks, _, _ = _adversarial_problem(kind, 8)
    _, rs = tplan.build_plan(ranks, NVOX)
    vals = np.random.RandomState(2).randn(len(rs), 96).astype(np.float32)
    vals[rs >= NVOX] = 0.0
    bounds = np.searchsorted(rs, np.arange(NVOX + 1), side="left")
    np.testing.assert_array_equal(bounds, tplan.plan_bounds(rs, NVOX))
    got = _kernel_model(vals, bounds, 1, tpool.CHUNK_ROWS)
    want = _splat_sorted(jnp.asarray(vals), jnp.asarray(rs), NVOX, True)
    _close(got, np.asarray(want))


# Group rows handed to JAX in the hypothesis test: every plan of at most 400
# points has fewer (plan_budget: at most 2,048 rows of group 1, 1,024 groups
# of 2, 640 of 8), so JAX sees one shape and compiles once.
JAX_GROUP_ROWS = 2048


@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ranks=st.lists(st.integers(0, NVOX), min_size=1, max_size=400),
       group=st.sampled_from([1, 2, 8]),
       chunk_rows=st.sampled_from([1, 7, 32, 128]),
       seed=st.integers(0, 2**16))
def test_chunk_model_hypothesis_ranks(ranks, group, chunk_rows, seed):
    """Any rank array, any group and chunk size: the partition writes every
    voxel once and sums to the JAX segment_sum_bounds."""
    ranks = np.asarray(ranks, np.int32)
    rng = np.random.RandomState(seed)
    dp = rng.rand(len(ranks)).astype(np.float32)
    feat = rng.randn(len(ranks), 4).astype(np.float32)  # HW = P: D = 1
    order, rs, bounds = _plan(ranks, group)
    rows = _lifted_rows(dp, feat, order)
    got = _kernel_model(rows, bounds, group, chunk_rows)
    # zero rows past the plan's end change no boundary's sum
    grouped = rows.reshape(-1, group, 4).sum(1)
    pad = JAX_GROUP_ROWS - len(grouped)
    assert pad >= 0
    want = jpool.segment_sum_bounds(
        jnp.asarray(np.pad(grouped, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(rs[::group], (0, pad),
                           constant_values=NVOX + tplan.TILE)),
        jnp.asarray(bounds), NVOX)
    _close(got, np.asarray(want))


def test_chunk_partition_counts():
    """chunk_partition on a hand-made plan: voxel 1 fills rows 0-2, voxel 3
    rows 3-299 (chunks 0-2), voxel 4 row 300; 0 and 2 are empty."""
    part = chunk_partition(np.array([0, 0, 3, 3, 300, 301]), 1, 320, 128)
    assert part["n_chunks"] == 3 and part["longest"] == 297
    assert list(np.nonzero(part["direct"])[0]) == [1, 4]
    assert list(np.nonzero(part["crossing"])[0]) == [3]
    assert list(np.nonzero(part["empty"])[0]) == [0, 2]
    assert part["n_partials"] == 3
