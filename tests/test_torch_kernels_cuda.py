"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and skips
elsewhere. This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: fp32 1e-5 (the kernels sum in fp32, in another order than the
plain versions), bf16 output 2e-2 (one bf16 rounding), splats and conv3d
1e-4 of the output's scale (fp32 sums over up to 27 * 128 terms), bf16
conv3d 2e-2 of the output's scale (bf16 products summed in fp32 on the
tensor cores and in cuDNN, then one bf16 rounding each), the DCN
gather 1e-5 (fp32) and 2e-2 (bf16) of the output's scale, the row gather
exact. The plain conv3d runs with TF32 off, so both sides are fp32.
"""

import numpy as np
import pytest
import torch

from stereoscene_torch import _build
from stereoscene_torch.geometry import disparity_positions
from stereoscene_torch.ops import (
    conv3d,
    deform_conv,
    gather,
    gwc,
    splat_plan,
    voxel_pool,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    _build.load_kernels()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = tf32


def _features(dev, seed, b, h, w, c, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, h, w, c, generator=gen, device=dev).to(dtype)
                 for _ in range(2))


@pytest.mark.parametrize("calib", [707.0 * 0.54, 90.0, 20.0])
@pytest.mark.parametrize("shape", [(2, 8, 40, 16, 16, 8), (1, 4, 37, 12, 7, 4),
                                   (1, 48, 160, 64, 112, 32)])
def test_gwc_kernel_matches_plain(dev, shape, calib):
    b, h, w, c, d, g = shape
    left, right = _features(dev, 0, b, h, w, c)
    pos = disparity_positions(torch.full((b,), calib, device=dev), d)
    before = _build.launch_counts["gwc_warp"]
    got = gwc.fused_gwc_warp(left, right, pos, d, g)
    assert _build.launch_counts["gwc_warp"] == before + 1
    want = gwc.fused_gwc_warp(left, right, pos, d, g, use_kernel=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_gwc_kernel_boundary_positions(dev):
    left, right = _features(dev, 1, 1, 8, 24, 8)
    pos = torch.tensor([[-1.5, -0.4, 0.0, 0.6, 3.5, 6.9, 7.0, 8.2]],
                       device=dev)
    got = gwc.fused_gwc_warp(left, right, pos, 8, 4)
    want = gwc.fused_gwc_warp(left, right, pos, 8, 4, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_gwc_kernel_bf16_output(dev, in_dtype):
    left, right = _features(dev, 2, 1, 8, 16, 8, in_dtype)
    pos = disparity_positions(torch.full((1,), 14.0, device=dev), 8)
    got = gwc.fused_gwc_warp(left, right, pos, 8, 4, out_dtype=torch.bfloat16)
    want = gwc.fused_gwc_warp(left, right, pos, 8, 4,
                              out_dtype=torch.bfloat16, use_kernel=False)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _positions_per_sample(dev, b, k, d):
    """Sample 0: the flagship warp's positions for a calibration;
    sample 1 on: the boundary values -1.5, -0.4, 0, D-1, D, then seeded
    fractional values in [-1.5, D + 0.5]."""
    gen = torch.Generator(device=dev).manual_seed(k)
    rows = [disparity_positions(torch.full((1,), 60.0, device=dev), k)[0]]
    edge = torch.tensor([-1.5, -0.4, 0.0, d - 1.0, float(d)], device=dev)
    for _ in range(b - 1):
        rest = torch.rand(k - len(edge), generator=gen, device=dev)
        rows.append(torch.cat([edge, rest * (d + 2.0) - 1.5]))
    return torch.stack(rows)


@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(2, 3, 45, 64, 70, 24, 32),
                                   (2, 2, 70, 16, 20, 16, 8),
                                   (2, 2, 33, 32, 19, 12, 8)])
def test_gwc_kernel_tiles_and_dtypes(dev, shape, in_dtype, out_dtype):
    """W off the 32-column tile, K off the 56-depth chunk, B = 2 with
    different positions per sample (boundary values in sample 1), all
    four dtype pairs; cpg 2 takes the 8-groups-per-thread path, cpg 4
    the generic one."""
    b, h, w, c, k, d, g = shape
    left, right = _features(dev, 8, b, h, w, c, in_dtype)
    pos = _positions_per_sample(dev, b, k, d)
    got = gwc.fused_gwc_warp(left, right, pos, d, g, out_dtype=out_dtype)
    want = gwc.fused_gwc_warp(left, right, pos, d, g, out_dtype=out_dtype,
                              use_kernel=False)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (b, k, h, w, g)
    tol = 1e-5 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_gwc_kernel_refuses_what_it_does_not_take(dev):
    left, right = _features(dev, 3, 1, 4, 8, 8)
    pos = disparity_positions(torch.full((1,), 10.0, device=dev), 4)
    with pytest.raises(TypeError):
        gwc.fused_gwc_warp(left.half(), right.half(), pos, 4, 2)
    with pytest.raises(ValueError):
        gwc.fused_gwc_warp(left, right, pos, 4, 3)
    with pytest.raises(ValueError):
        gwc.fused_gwc_warp(left, right.cpu(), pos, 4, 2)


def _splat_problem(dev, seed, d=6, fh=4, fw=5, c=128, nvox=512):
    rng = np.random.RandomState(seed)
    p = d * fh * fw
    ranks = np.where(rng.rand(p) < 0.4, rng.randint(0, nvox, p), nvox)
    ranks[:20] = 7
    gen = torch.Generator(device=dev).manual_seed(seed)
    dp = torch.rand(p, generator=gen, device=dev)
    feat = torch.randn(fh * fw, c, generator=gen, device=dev)
    return ranks.astype(np.int32), dp, feat, nvox


@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("c", [128, 40])
def test_splat_fused_kernel_matches_plain(dev, group, c):
    ranks, dp, feat, nvox = _splat_problem(dev, group, c=c)
    order, rs = splat_plan.build_plan(ranks, nvox, group=group)
    bounds = torch.from_numpy(splat_plan.plan_bounds(rs, nvox, group)).to(dev)
    order = torch.from_numpy(order).to(dev)
    before = _build.launch_counts["lift_splat_fused"]
    got = voxel_pool.lift_splat_fused(dp, feat, order, bounds, group, nvox)
    assert _build.launch_counts["lift_splat_fused"] == before + 1
    want = voxel_pool.lift_splat_fused(dp, feat, order, bounds, group, nvox,
                                       use_kernel=False)
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


def test_splat_sorted_kernel_matches_plain(dev):
    ranks, _, _, nvox = _splat_problem(dev, 3)
    _, rs = splat_plan.build_plan(ranks, nvox)
    gen = torch.Generator(device=dev).manual_seed(3)
    vals = torch.randn(len(rs), 96, generator=gen, device=dev)
    rs = torch.from_numpy(rs).to(dev)
    vals[rs >= nvox] = 0.0
    before = _build.launch_counts["splat_sorted"]
    got = voxel_pool.splat_sorted(vals, rs, nvox)
    assert _build.launch_counts["splat_sorted"] == before + 1
    want = voxel_pool.splat_sorted(vals, rs, nvox, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


SPLAT_PLANS = ["long", "one voxel", "none", "last voxel", "random"]


def _adversarial_plan(kind, group, nvox=512, p=1536):
    """Plans that stress the chunked splat: a 1,360-row voxel (the
    flagship's longest), all rows in one voxel, no live row, only the last
    voxel, and a random ~40% in-bounds plan."""
    rng = np.random.RandomState(11)
    if kind == "long":
        ranks = np.where(rng.rand(p) < 0.3, rng.randint(0, nvox, p), nvox)
        ranks[rng.permutation(p)[:1360]] = 7
    elif kind == "one voxel":
        ranks = np.full(p, 300)
    elif kind == "none":
        ranks = np.full(p, nvox)
    elif kind == "last voxel":
        ranks = np.where(rng.rand(p) < 0.5, nvox - 1, nvox)
    else:
        ranks = np.where(rng.rand(p) < 0.4, rng.randint(0, nvox, p), nvox)
        ranks[:20] = 7
    order, rs = splat_plan.build_plan(ranks.astype(np.int32), nvox,
                                      group=group)
    return order, rs, splat_plan.plan_bounds(rs, nvox, group)


def _check_splat(got, again, want):
    """Within 1e-4 of max|ref| of the plain version, and two launches
    bitwise equal (the kernel has no atomics)."""
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("chunk_rows", [32, 64, 128])
@pytest.mark.parametrize("c", [128, 96, 40, 37])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("kind", SPLAT_PLANS)
def test_splat_fused_kernel_chunks(dev, monkeypatch, kind, group, c,
                                   chunk_rows):
    """K3 on plans whose voxels span many chunks (1,360 rows: 43 chunks of
    32, 11 of 128), chunks that begin and end inside one voxel, empty
    plans; C = 37 takes the scalar-load path."""
    monkeypatch.setattr(voxel_pool, "CHUNK_ROWS", chunk_rows)
    order, rs, bounds = _adversarial_plan(kind, group)
    gen = torch.Generator(device=dev).manual_seed(12)
    dp = torch.rand(1536, generator=gen, device=dev)
    feat = torch.randn(8 * 24, c, generator=gen, device=dev)
    order = torch.from_numpy(order).to(dev)
    bounds = torch.from_numpy(bounds).to(dev)

    def run(use_kernel=None):
        return voxel_pool.lift_splat_fused(dp, feat, order, bounds, group,
                                           512, use_kernel=use_kernel)

    got, again, want = run(), run(), run(False)
    _check_splat(got, again, want)
    if kind == "none":
        assert not got.any()


def test_splat_fused_kernel_unaligned_table(dev):
    """A feature table 4 bytes off a 16-byte boundary takes the scalar
    loads and agrees all the same."""
    order, rs, bounds = _adversarial_plan("random", 8)
    gen = torch.Generator(device=dev).manual_seed(13)
    dp = torch.rand(1536, generator=gen, device=dev)
    feat = torch.randn(192 * 128 + 1, generator=gen, device=dev)[1:]
    feat = feat.view(192, 128)
    assert feat.data_ptr() % 16
    order = torch.from_numpy(order).to(dev)
    bounds = torch.from_numpy(bounds).to(dev)
    got = voxel_pool.lift_splat_fused(dp, feat, order, bounds, 8, 512)
    again = voxel_pool.lift_splat_fused(dp, feat, order, bounds, 8, 512)
    want = voxel_pool.lift_splat_fused(dp, feat, order, bounds, 8, 512,
                                       use_kernel=False)
    _check_splat(got, again, want)


@pytest.mark.parametrize("chunk_rows", [32, 64, 128])
@pytest.mark.parametrize("c", [128, 40, 37])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("kind", SPLAT_PLANS)
def test_splat_fused_kernel_bf16_tables(dev, monkeypatch, kind, group, c,
                                        chunk_rows):
    """bf16 dp and feat (serving's dtype): the kernel widens them to fp32
    and sums them as it sums their fp32 copies, in another order (a
    half-warp per row of a pair), so within the same 1e-4 of max|ref|.
    Group 1 puts voxel boundaries on odd rows, between the two rows of a
    pair."""
    monkeypatch.setattr(voxel_pool, "CHUNK_ROWS", chunk_rows)
    order, rs, bounds = _adversarial_plan(kind, group)
    gen = torch.Generator(device=dev).manual_seed(15)
    dp = torch.rand(1536, generator=gen, device=dev).bfloat16()
    feat = torch.randn(192, c, generator=gen, device=dev).bfloat16()
    order = torch.from_numpy(order).to(dev)
    bounds = torch.from_numpy(bounds).to(dev)

    def run(tables, use_kernel=None):
        return voxel_pool.lift_splat_fused(*tables, order, bounds, group,
                                           512, use_kernel=use_kernel)

    got, again, want = run((dp, feat)), run((dp, feat)), run((dp, feat),
                                                             False)
    _check_splat(got, again, want)
    assert got.dtype == torch.float32
    _check_splat(got, again, run((dp.float(), feat.float())))
    if group == 1 and kind == "random":  # a boundary falls inside a pair
        assert (bounds[1:-1] % 2).any()


@pytest.mark.parametrize("chunk_rows", [32, 64, 128])
@pytest.mark.parametrize("c", [128, 96, 40])
@pytest.mark.parametrize("kind", SPLAT_PLANS)
def test_splat_sorted_kernel_chunks(dev, monkeypatch, kind, c, chunk_rows):
    """K2 on the same plans; its pad rows carry nonzero values, which the
    kernel must leave out."""
    monkeypatch.setattr(voxel_pool, "CHUNK_ROWS", chunk_rows)
    _, rs, _ = _adversarial_plan(kind, 1)
    gen = torch.Generator(device=dev).manual_seed(14)
    vals = torch.randn(len(rs), c, generator=gen, device=dev)
    rs = torch.from_numpy(rs).to(dev)
    got = voxel_pool.splat_sorted(vals, rs, 512)
    again = voxel_pool.splat_sorted(vals, rs, 512)
    want = voxel_pool.splat_sorted(vals, rs, 512, use_kernel=False)
    _check_splat(got, again, want)


def test_gwc_backward_matches_plain(dev):
    """The K1 Function's grads against autograd through the plain pair;
    positions get a zero grad."""
    left, right = _features(dev, 4, 2, 6, 20, 16)
    pos = disparity_positions(torch.tensor([60.0, 25.0], device=dev), 12)
    g = torch.randn(2, 12, 6, 20, 4, device=dev)
    ins = [t.clone().requires_grad_() for t in (left, right, pos)]
    before = _build.launch_counts["gwc_warp"]
    (gwc.fused_gwc_warp(*ins, 12, 4) * g).sum().backward()
    assert _build.launch_counts["gwc_warp"] == before + 1
    ref = [t.clone().requires_grad_() for t in (left, right)]
    (gwc.gwc_warp_plain(*ref, pos, 12, 4) * g).sum().backward()
    for got, want in zip(ins[:2], ref):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5, atol=1e-5)
    assert not ins[2].grad.any()


def _volume(dev, seed, shape, dtype=torch.float32):
    b, ci, d, h, w, co = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, ci, d, h, w, generator=gen, device=dev)
    wt = torch.randn(co, ci, 3, 3, 3, generator=gen, device=dev) * ci ** -0.5
    return x.to(dtype), wt.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 5, 6, 7, 64), (2, 128, 4, 3, 9, 72),
                                   (1, 64, 56, 24, 80, 64),
                                   (1, 128, 28, 12, 40, 128),
                                   (1, 128, 64, 64, 8, 128)])
def test_conv3d_kernel_matches_plain(dev, dtype, shape):
    """Odd W, Co off the 64-tile, and the three flagship shapes."""
    x, wt = _volume(dev, 5, shape, dtype)
    before = _build.launch_counts["conv3d_s1"]
    got = conv3d.conv3d_s1(x, wt)
    assert _build.launch_counts["conv3d_s1"] == before + 1
    want = conv3d.conv3d_s1_plain(x, wt)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (1, 64, 3, 5, 7, 64), (1, 128, 5, 9, 11, 64), (2, 64, 4, 6, 5, 72),
    (2, 128, 1, 1, 1, 64), (1, 64, 2, 3, 1, 72)])
def test_conv3d_kernel_edges(dev, dtype, shape):
    """M off the 128-row block (105, 495 voxels), Co = 72, B = 2, and
    volumes where every tap but the centre falls in the halo (1x1x1,
    2x3x1)."""
    x, wt = _volume(dev, 9, shape, dtype)
    got = conv3d.conv3d_s1(x, wt)
    want = conv3d.conv3d_s1_plain(x, wt)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.parametrize("block_n", [64, 128])
@pytest.mark.parametrize("shape", [(2, 128, 3, 4, 13, 72),
                                   (1, 64, 6, 5, 9, 128)])
def test_conv3d_bf16_both_tiles(dev, monkeypatch, shape, block_n):
    """Each N tile of the tensor-core route, whatever the wrapper would
    pick for Co; Co = 72 leaves most of a 128 tile empty."""
    monkeypatch.setattr(conv3d, "tile_n", lambda co: block_n)
    x, wt = _volume(dev, 10, shape, torch.bfloat16)
    got = conv3d.conv3d_s1(x, wt)
    want = conv3d.conv3d_s1_plain(x, wt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2e-2 * float(want.float().abs().max()))


def test_conv3d_bf16_layouts_and_repeats(dev):
    """A non-channels-last input gives the output of its channels-last
    copy, and two bf16 launches on the same input are bitwise equal."""
    x, wt = _volume(dev, 11, (1, 128, 28, 12, 40, 128), torch.bfloat16)
    assert not x.is_contiguous(memory_format=torch.channels_last_3d)
    first = conv3d.conv3d_s1(x, wt)
    xcl = x.contiguous(memory_format=torch.channels_last_3d)
    second = conv3d.conv3d_s1(xcl, wt)
    third = conv3d.conv3d_s1(xcl, wt)
    torch.cuda.synchronize()
    assert first.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(first, second) and torch.equal(second, third)


def test_conv3d_kernel_refuses_what_it_does_not_take(dev):
    x, wt = _volume(dev, 6, (1, 32, 4, 4, 4, 64))
    with pytest.raises(ValueError):
        conv3d.conv3d_s1(x, wt)
    x, wt = _volume(dev, 6, (1, 64, 4, 4, 4, 64))
    with pytest.raises(TypeError):
        conv3d.conv3d_s1(x.half(), wt.half())
    with pytest.raises(ValueError):
        conv3d.conv3d_s1(x, wt.cpu())


def test_conv3d_backward_matches_plain(dev):
    x, wt = _volume(dev, 7, (2, 64, 4, 5, 6, 64))
    g = torch.randn(2, 64, 4, 5, 6, device=dev)
    ins = [t.clone().requires_grad_() for t in (x, wt)]
    (conv3d.conv3d_s1(*ins) * g).sum().backward()
    ref = [t.clone().requires_grad_() for t in (x, wt)]
    (conv3d.conv3d_s1_plain(*ref) * g).sum().backward()
    for got, want in zip(ins, ref):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5, atol=1e-4)


def _dcn_problem(dev, seed, b, h, w, c, groups=4, dtype=torch.float32):
    """x, offsets at the probe's scale (randn * 1.5, samples off the map
    included) and tap weights [9, C / G, C]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=gen, device=dev)
    offsets = torch.randn(b, h, w, 18, generator=gen, device=dev) * 1.5
    weights = torch.randn(9, c // groups, c, generator=gen, device=dev)
    return x.to(dtype), offsets, (weights * 0.02).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 7, 9, 64), (1, 48, 160, 640)])
def test_dcn_gather_kernel_matches_plain(dev, dtype, shape):
    x, offsets, weights = _dcn_problem(dev, 8, *shape, dtype=dtype)
    z = deform_conv.dcn_z(x, weights, 4)
    before = _build.launch_counts["dcn_gather"]
    got = deform_conv.dcn_gather_kernel(z, offsets)
    assert _build.launch_counts["dcn_gather"] == before + 1
    want = deform_conv.dcn_gather_plain(z, offsets)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


def test_dcn_route_and_gradients_match_plain(dev):
    """The kernel route against the plain gather DCN in fp32, and the
    Function's gradients (offsets included) against plain autograd."""
    x, offsets, weights = _dcn_problem(dev, 9, 2, 6, 11, 32)
    g = torch.randn(2, 6, 11, 32, device=dev)
    ins = [t.clone().requires_grad_() for t in (x, offsets, weights)]
    out = deform_conv.deform_conv2d(*ins, groups=4)
    ref = [t.clone().requires_grad_() for t in (x, offsets, weights)]
    want = deform_conv.deform_conv2d_plain(*ref, groups=4)
    torch.testing.assert_close(out, want, rtol=0,
                               atol=1e-5 * float(want.detach().abs().max()))
    (out * g).sum().backward()
    (want * g).sum().backward()
    for got, exp in zip(ins, ref):
        torch.testing.assert_close(got.grad, exp.grad, rtol=0,
                                   atol=1e-5 * float(exp.grad.abs().max()))
    assert float(ins[1].grad.abs().max()) > 0


def test_dcn_gather_kernel_refuses_what_it_does_not_take(dev):
    x, offsets, weights = _dcn_problem(dev, 10, 1, 4, 5, 12, groups=4)
    z = deform_conv.dcn_z(x, weights, 4)
    with pytest.raises(ValueError):  # 10 fp32 channels: not 16-byte rows
        deform_conv.dcn_gather_kernel(z[:, :, :10], offsets)
    with pytest.raises(TypeError):
        deform_conv.dcn_gather_kernel(z.half(), offsets)
    with pytest.raises(ValueError):
        deform_conv.dcn_gather_kernel(z, offsets.cpu())
    with pytest.raises(ValueError):  # offsets of another map
        deform_conv.dcn_gather_kernel(z, offsets[:, :3])


def _dcn_gather_problem(dev, seed, kw, b, h, w, c, dtype, layout):
    """z [K, B*H*W, C] in ``dtype`` and offsets [B, H, W, 2K] at the
    probe's scale with whole rows and columns of samples pushed off the
    map; ``layout`` "fp32" gives them contiguous, "bf16 nchw" as serving
    hands them: a bf16 [B, 2K, H, W] tensor seen through permute."""
    k = kw * kw
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(k, b * h * w, c, generator=gen, device=dev).to(dtype)
    off = torch.randn(b, 2 * k, h, w, generator=gen, device=dev) * 1.5
    off[:, 0::2, 0] = -(h + 2.0)  # dy: image row 0 samples above the map
    off[:, 1::2, :, -1] = w + 1.5  # dx: the last column right of it
    if layout == "fp32":
        return z, off.permute(0, 2, 3, 1).contiguous()
    return z, off.bfloat16().permute(0, 2, 3, 1)


@pytest.mark.parametrize("layout", ["fp32", "bf16 nchw"])
@pytest.mark.parametrize("shape", [(2, 7, 9, 16), (1, 5, 37, 136),
                                   (2, 6, 17, 640)])
@pytest.mark.parametrize("kw", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dcn_gather_kernel_tiles_slices_and_offsets(dev, dtype, kw, shape,
                                                    layout):
    """Tiles cut by H and W, tail channel slices (C 16, 136), B = 2, kw 1-3,
    fp32 and permuted bf16 offsets, corners off the map; two launches
    bitwise equal."""
    z, off = _dcn_gather_problem(dev, 12, kw, *shape, dtype, layout)
    assert layout == "fp32" or not off.is_contiguous()
    got = deform_conv.dcn_gather_kernel(z, off)
    again = deform_conv.dcn_gather_kernel(z, off)
    want = deform_conv.dcn_gather_plain(z, off)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))
    assert torch.equal(got, again)


def test_dcn_gather_kernel_reads_offsets_in_place(dev):
    """The permuted bf16 offsets give the output of their fp32 contiguous
    copy bit for bit (the kernel widens them exactly), with no copy made."""
    z, off = _dcn_gather_problem(dev, 13, 3, 1, 48, 160, 640, torch.bfloat16,
                                 "bf16 nchw")
    got = deform_conv.dcn_gather_kernel(z, off)
    want = deform_conv.dcn_gather_kernel(z, off.float().contiguous())
    assert torch.equal(got, want)


def test_every_wrapper_counts_one_launch(dev):
    """Each of the six wrappers launches through ``_build.launch`` and
    counts exactly one launch per call."""
    gen = torch.Generator(device=dev).manual_seed(14)
    left, right = _features(dev, 3, 1, 4, 16, 8)
    pos = disparity_positions(torch.full((1,), 14.0, device=dev), 8)
    x, wt = _volume(dev, 15, (1, 64, 4, 4, 4, 64))
    z, off = _dcn_gather_problem(dev, 16, 3, 1, 4, 5, 16, torch.float32,
                                 "fp32")
    feat = torch.randn(30, 8, generator=gen, device=dev)
    idx = torch.randint(0, 30, (12,), generator=gen, device=dev,
                        dtype=torch.int32)
    vals = torch.randn(6, 8, generator=gen, device=dev)
    ranks = torch.tensor([0, 0, 1, 3, 3, 9], dtype=torch.int32, device=dev)
    order = torch.arange(8, dtype=torch.int32, device=dev)
    bounds = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device=dev)
    calls = {
        "gwc_warp": lambda: gwc.fused_gwc_warp(left, right, pos, 8, 4),
        "conv3d_s1": lambda: conv3d.conv3d_s1(x, wt),
        "dcn_gather": lambda: deform_conv.dcn_gather_kernel(z, off),
        "take_rows": lambda: gather.take_along_rows(feat, idx),
        "splat_sorted": lambda: voxel_pool.splat_sorted(vals, ranks, 4),
        "lift_splat_fused": lambda: voxel_pool.lift_splat_fused(
            torch.rand(8, device=dev), feat[:4], order, bounds, 4, 3),
    }
    assert set(calls) == set(_build.SIGNATURES)
    for name, call in calls.items():
        before = dict(_build.launch_counts)
        call()
        after = dict(_build.launch_counts)
        changed = {k: after[k] - before.get(k, 0) for k in after
                   if after[k] != before.get(k, 0)}
        assert changed == {name: 1}, name
    torch.cuda.synchronize()


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("c", [1, 3, 128, 129])
@pytest.mark.parametrize("layout", ["per element", "per row", "flat"])
def test_take_rows_kernel_widths_and_alignment(dev, layout, c, aligned):
    """Bitwise equal to the plain version for M not a multiple of a
    block's 8 rows, C 1, 3, 128 and 129, and a feat that starts 4 bytes
    past a 16-byte boundary (the scalar path)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    r, m = 300, 1021
    base = torch.randn(r * c + 1, generator=gen, device=dev)
    feat = (base[:-1] if aligned else base[1:]).view(r, c)
    assert (feat.data_ptr() % 16 == 0) == aligned
    shape = {"per element": (m, c), "per row": (m, 1), "flat": (m,)}[layout]
    idx = torch.randint(0, r, shape, generator=gen, device=dev,
                        dtype=torch.int32)
    got = gather.take_along_rows(feat, idx)
    want = gather.take_along_rows(feat, idx, use_kernel=False)
    assert got.shape == (m, c) and torch.equal(got, want)


@pytest.mark.parametrize("layout", [(1024, 128), (1024, 1), (1024,)])
def test_take_rows_kernel_is_exact(dev, layout):
    gen = torch.Generator(device=dev).manual_seed(11)
    feat = torch.randn(7680, 128, generator=gen, device=dev)
    idx = torch.randint(0, 7680, layout, generator=gen, device=dev,
                        dtype=torch.int32)
    before = _build.launch_counts["take_rows"]
    got = gather.take_along_rows(feat, idx)
    assert _build.launch_counts["take_rows"] == before + 1
    want = gather.take_along_rows(feat, idx, use_kernel=False)
    assert torch.equal(got, want)


def test_take_rows_kernel_clamps_a_bad_index(dev):
    """The kernel reads the nearest row for an index outside [0, R), where
    the plain route raises (ops/gather.py: take_along_rows)."""
    feat = torch.randn(300, 128, device=dev)
    idx = torch.tensor([-5, 0, 299, 300, 10**6], dtype=torch.int32,
                       device=dev)
    got = gather.take_along_rows(feat, idx)
    want = gather.take_along_rows(feat, idx.clamp(0, 299), use_kernel=False)
    assert torch.equal(got, want)
