"""Kernel K4 (3x3x3 stride-1 conv3d) of the port against the JAX package.

On the CPU ``conv3d_s1`` runs its plain version, ``F.conv3d``; the JAX side
is ``conv3d_s1_pallas`` in interpret mode, so both the kernel's reference
and its tap algebra are held to the JAX package. The backward (the JAX
package's plain fp32 VJP) is the same whichever forward ran, so it is
tested here with the plain forward injected. fp32: forward within 1e-5,
gradients within 1e-4 (the JAX tests' limits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereoscene_tpu.models.layers as jlayers
import stereoscene_tpu.ops.pallas_conv3d as jconv
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_torch.models.layers import Conv3d
from stereoscene_torch.ops import conv3d
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import port_model


def _problem(seed, b, ci, d, h, w, co):
    """x [B, D, H, W, Ci] and w [3, 3, 3, Ci, Co] (the JAX layouts)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d, h, w, ci).astype(np.float32)
    wt = (rng.randn(3, 3, 3, ci, co) * ci ** -0.5).astype(np.float32)
    return x, wt


def _torch_args(x, wt):
    return (torch.from_numpy(x).permute(0, 4, 1, 2, 3),
            torch.from_numpy(wt).permute(4, 3, 0, 1, 2).contiguous())


@pytest.mark.parametrize("shape", [(1, 64, 3, 4, 10, 64),
                                   (2, 128, 2, 3, 7, 72),
                                   (1, 64, 4, 2, 20, 128)])
def test_plain_matches_pallas_interpret(shape):
    """Ci 64 / 128, W off the 16-row tile (10, 7, 20), Co off 64."""
    x, wt = _problem(0, *shape)
    want = np.asarray(jconv.conv3d_s1_pallas(jnp.asarray(x), jnp.asarray(wt),
                                             True))
    got = conv3d.conv3d_s1(*_torch_args(x, wt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def _gemm_walk(x, wk, block_k=64):
    """The bf16 kernel's arithmetic in plain fp32: for each of the 27 taps
    and each 64-channel slice, the shifted input rows (zero in the halo)
    times that slice of the K-major weights [27, Co, Ci], summed into
    [B, D, H, W, Co]."""
    b, ci, d, h, w = x.shape
    co = wk.shape[1]
    xp = torch.nn.functional.pad(x.permute(0, 2, 3, 4, 1),
                                 (0, 0, 1, 1, 1, 1, 1, 1))
    acc = torch.zeros(b * d * h * w, co)
    for tap in range(27):
        kd, kh, kw = tap // 9, tap // 3 % 3, tap % 3
        rows = xp[:, kd:kd + d, kh:kh + h, kw:kw + w].reshape(-1, ci)
        for c0 in range(0, ci, block_k):
            acc += rows[:, c0:c0 + block_k] @ wk[tap, :, c0:c0 + block_k].T
    return acc.view(b, d, h, w, co)


@pytest.mark.parametrize("shape", [(2, 64, 3, 4, 7, 64),
                                   (2, 128, 2, 3, 5, 72),
                                   (2, 64, 2, 5, 9, 72),
                                   (2, 128, 3, 2, 7, 64)])
def test_packed_gemm_walk_matches_pallas_interpret(shape):
    """The weights packed for the tensor cores, walked tap by tap and
    slice by slice as the kernel walks them: Ci 64 / 128, Co 64 / 72, odd
    W, B = 2."""
    x, wt = _problem(3, *shape)
    want = np.asarray(jconv.conv3d_s1_pallas(jnp.asarray(x), jnp.asarray(wt),
                                             True))
    xt, wtt = _torch_args(x, wt)
    wk = conv3d.pack_weight_kmajor(wtt)
    assert wk.shape == (27, shape[-1], shape[1]) and wk.is_contiguous()
    np.testing.assert_allclose(_gemm_walk(xt, wk).numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("args,block_n,blocks", [
    ((1, 56 * 24 * 80, 64), 64, 840),     # hourglass conv2
    ((1, 28 * 12 * 40, 128), 128, 105),   # hourglass conv4
    ((1, 64 * 64 * 8, 128), 128, 256),    # ResNet3D stage 1
    ((2, 5 * 6 * 7, 72), 128, 4)])
def test_tile_n(args, block_n, blocks):
    """The N tile the bf16 kernel gets per shape, and its grid."""
    batch, voxels, co = args
    assert conv3d.tile_n(co) == block_n
    grid = batch * -(-voxels // conv3d.BLOCK_M) * -(-co // block_n)
    assert grid == blocks


def test_backward_matches_jax_vjp():
    """The Function's backward with the plain forward against jax.grad
    through conv3d_s1_pallas's custom VJP."""
    x, wt = _problem(1, 2, 64, 3, 4, 6, 64)

    def loss(xx, ww):
        return jnp.sum(jnp.sin(jconv.conv3d_s1_pallas(xx, ww, True)))

    gx, gw = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(wt))
    xt, wtt = (t.clone().requires_grad_() for t in _torch_args(x, wt))
    y = conv3d.Conv3dS1.apply(xt, wtt, conv3d.conv3d_s1_plain)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(gx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wtt.grad.permute(2, 3, 4, 1, 0).numpy(),
                               np.asarray(gw), rtol=1e-4, atol=1e-4)


def test_cpu_route_rules():
    x, wt = _torch_args(*_problem(2, 1, 64, 2, 2, 3, 64))
    with pytest.raises(ValueError, match="CUDA"):
        conv3d.conv3d_s1(x, wt, use_kernel=True)
    torch.testing.assert_close(conv3d.conv3d_s1(x, wt),
                               conv3d.conv3d_s1_plain(x, wt))


@pytest.mark.parametrize("args,claims", [
    ((64, 64, 3, 1, 1), True), ((128, 128, 3, 1, 1), True),
    ((64, 256, 3, 1, 1), True), ((32, 64, 3, 1, 1), False),
    ((64, 32, 3, 1, 1), False), ((64, 64, 3, 2, 1), False),
    ((64, 64, 1, 1, 0), False), ((96, 128, 3, 1, 1), False)])
def test_conv3d_gate(args, claims):
    cin, cout, k, s, p = args
    assert Conv3d(cin, cout, k, s, p, kernel=True).k4 is claims
    assert not Conv3d(cin, cout, k, s, p, kernel=False).k4


def _jax_claims():
    """(input shape [B, D, H, W, Ci], Co) of every conv the JAX ConvNd gate
    sends to the Pallas kernel in the TINY detector's training forward,
    with the gate's switch (STEREOSCENE_PALLAS_CONV3D=1 off the CPU)
    forced on."""
    seen = []

    def record(x, w, interpret=False):
        seen.append((tuple(x.shape), int(w.shape[-1])))
        return jconv._plain_conv3d_s1(x, w)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "_pallas_conv3d_enabled", lambda: True)
        mp.setattr(jconv, "conv3d_s1_pallas", record)
        jax.eval_shape(lambda: JaxModel(cfg=TINY).init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            _tiny_batch(b=2), train=True))
    return sorted(seen)


def test_gate_claims_what_jax_claims():
    """The port's TINY detector built with ``conv3d_kernel=True`` sends to
    K4 exactly the convs (by input shape and Co) that the JAX gate sends
    to its Pallas kernel: conv2 and conv4 of the four hourglasses."""
    model = port_model(conv3d_kernel=True).train()
    seen = []
    for m in model.modules():
        if isinstance(m, Conv3d) and m.k4:
            m.register_forward_pre_hook(lambda mod, args: seen.append(
                (tuple(args[0].permute(0, 2, 3, 4, 1).shape),
                 mod.out_channels)))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in _tiny_batch(b=2).items()}
    with torch.no_grad():
        model(batch)
    assert len(seen) == 8
    assert sorted(seen) == _jax_claims()
