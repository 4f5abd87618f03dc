"""The port's group-wise correlation + depth warp (the plain version of
kernel K1, which CPU tensors take) against the JAX package's unfused pair
and its fused Pallas kernel in interpret mode, on the cases of
tests/test_pallas_gwc.py. fp32 within 1e-5; bf16 output within 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.geometry import disparity_positions
from stereoscene_tpu.ops.gwc import (
    groupwise_correlation_volume,
    warp_disparity_to_depth,
)
from stereoscene_tpu.ops.pallas_gwc import fused_gwc_warp as jax_fused
from stereoscene_torch.ops import gwc as tgwc


def _jax_unfused(left, right, pos, d, g):
    vol = groupwise_correlation_volume(jnp.asarray(left), jnp.asarray(right),
                                       d, g)
    return np.asarray(warp_disparity_to_depth(vol, jnp.asarray(pos)))


def _jax_interpret(left, right, pos, d, g):
    return np.asarray(jax_fused(jnp.asarray(left), jnp.asarray(right),
                                jnp.asarray(pos), d, g, interpret=True))


def _port(left, right, pos, d, g, **kw):
    out = tgwc.fused_gwc_warp(torch.from_numpy(left), torch.from_numpy(right),
                              torch.from_numpy(pos), d, g, **kw)
    return out


def _inputs(seed, b, h, w, c):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32))


def _positions(calib, b, d):
    return np.asarray(disparity_positions(
        jnp.full((b,), calib, jnp.float32), d))


@pytest.mark.parametrize("reference", [_jax_unfused, _jax_interpret])
@pytest.mark.parametrize("calib", [707.0 * 0.54, 90.0, 20.0])
def test_matches_jax(calib, reference):
    b, h, w, c, d, g = 2, 8, 40, 16, 16, 8
    left, right = _inputs(0, b, h, w, c)
    pos = _positions(calib, b, d)
    got = _port(left, right, pos, d, g)
    assert got.shape == (b, d, h, w, g) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), reference(left, right, pos, d, g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference", [_jax_unfused, _jax_interpret])
def test_boundary_positions(reference):
    """Positions straddling -1, 0, D-1 and D exercise every clip branch."""
    b, h, w, c, d, g = 1, 8, 24, 8, 8, 4
    left, right = _inputs(1, b, h, w, c)
    pos = np.asarray([[-1.5, -0.4, 0.0, 0.6, 3.5, 6.9, 7.0, 8.2]], np.float32)
    np.testing.assert_allclose(_port(left, right, pos, d, g).numpy(),
                               reference(left, right, pos, d, g),
                               rtol=1e-5, atol=1e-5)


def test_k_not_multiple_and_odd_width():
    """K = 5 is no multiple of any tile and W = 37 of no block; K != D."""
    b, h, w, c, d, g = 1, 4, 37, 12, 7, 4
    left, right = _inputs(2, b, h, w, c)
    pos = _positions(12.0, b, 5)
    np.testing.assert_allclose(_port(left, right, pos, d, g).numpy(),
                               _jax_unfused(left, right, pos, d, g),
                               rtol=1e-5, atol=1e-5)


def test_bf16_output():
    b, h, w, c, d, g = 1, 8, 16, 8, 8, 4
    left, right = _inputs(3, b, h, w, c)
    pos = _positions(14.0, b, d)
    lb = torch.from_numpy(left).bfloat16()
    rb = torch.from_numpy(right).bfloat16()
    got = tgwc.fused_gwc_warp(lb, rb, torch.from_numpy(pos), d, g)
    assert got.dtype == torch.bfloat16
    want = _jax_interpret(lb.float().numpy(), rb.float().numpy(), pos, d, g)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_cpu_route_rules():
    """A CPU tensor takes the plain version, may not ask for the kernel,
    and is differentiable (the forward-only rule binds the kernel)."""
    left, right = (torch.from_numpy(a).requires_grad_()
                   for a in _inputs(4, 1, 2, 6, 4))
    pos = torch.from_numpy(_positions(10.0, 1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tgwc.fused_gwc_warp(left, right, pos, 4, 2, use_kernel=True)
    out = tgwc.fused_gwc_warp(left, right, pos, 4, 2)
    out.sum().backward()
    assert left.grad is not None and torch.isfinite(left.grad).all()


@pytest.mark.parametrize("calib", [707.0 * 0.54, 20.0])
def test_backward_matches_jax_custom_vjp(calib):
    """The K1 Function's backward (plain autograd through the unfused pair,
    the JAX package's ``_fused_bwd``) against jax.grad through the fused
    kernel's custom VJP in interpret mode; positions get a zero grad."""
    import jax

    b, h, w, c, d, g = 2, 4, 24, 16, 16, 8
    left, right = _inputs(5, b, h, w, c)
    pos = _positions(calib, b, d)
    cot = np.random.RandomState(6).randn(b, d, h, w, g).astype(np.float32)

    def loss(lf, rt, ps):
        out = jax_fused(lf, rt, ps, d, g, interpret=True)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(a)
                                       for a in (left, right, pos)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (left, right, pos)]
    (tgwc.fused_gwc_warp(*ins, d, g) * torch.from_numpy(cot)).sum().backward()
    for got, ref in zip(ins, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    assert not ins[2].grad.any()
