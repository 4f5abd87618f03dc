"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and skips
elsewhere. This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: fp32 1e-5 (the kernels sum in fp32, in another order than the
plain versions), bf16 output 2e-2 (one bf16 rounding), splats and conv3d
1e-4 of the output's scale (fp32 sums over up to 27 * 128 terms), the DCN
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
