"""The port's z-gather DCN route (P1's tables, products and plain gather)
against the JAX package's ``deform_conv2d``.

The JAX function is the reference the Pallas probe validates its kernel
against (tools/probe_pallas_dcn.py:162-167). Inputs come from numpy seeds at
small odd sizes, B = 2, G = 4, offsets at the probe's scale (randn * 1.5),
so samples fall off the map. fp32 within 1e-5 of max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.ops.deform_conv import deform_conv2d as jax_dcn
from stereoscene_torch.ops import deform_conv
from tests.test_torch_modules import _features, _nchw, bridged  # noqa: F401


def _problem(seed, b=2, h=7, w=9, c=16, groups=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    offsets = (rng.randn(b, h, w, 18) * 1.5).astype(np.float32)
    weights = (rng.randn(9, c // groups, c) * 0.2).astype(np.float32)
    return x, offsets, weights


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err:.3e} vs scale {scale:.3e}"


@pytest.mark.parametrize("seed,shape", [(0, (2, 7, 9, 16)),
                                        (1, (2, 5, 11, 32)),
                                        (2, (1, 3, 3, 8))])
def test_z_gather_route_matches_jax(seed, shape):
    b, h, w, c = shape
    x, offsets, weights = _problem(seed, b, h, w, c)
    want = jax_dcn(jnp.asarray(x), jnp.asarray(offsets), jnp.asarray(weights),
                   None, groups=4)
    idx, wgt = deform_conv.dcn_corner_tables(torch.from_numpy(offsets), h, w)
    assert idx.dtype == torch.int32 and wgt.dtype == torch.float32
    assert idx.shape == wgt.shape == (b * h * w, 9, 4)
    assert int(idx.min()) >= 0 and int(idx.max()) < b * h * w
    # the probe's scale of offsets sends some corners off the map
    assert float((wgt == 0).float().mean()) > 0.01
    z = deform_conv.dcn_z(torch.from_numpy(x), torch.from_numpy(weights), 4)
    assert z.shape == (9, b * h * w, c)
    got = deform_conv.dcn_gather_plain(z, torch.from_numpy(offsets))
    got = got.view(b, h, w, c)
    _close(got, want)
    plain = deform_conv.deform_conv2d_plain(
        torch.from_numpy(x), torch.from_numpy(offsets),
        torch.from_numpy(weights), groups=4)
    _close(plain, want)


def test_corner_tables_rows_and_weights():
    """A row's four weights sum to 1 where its sample's corners are all on
    the map, and every index carries its batch offset."""
    b, h, w = 2, 6, 8
    offsets = torch.zeros(b, h, w, 18)
    offsets[..., 0::2] = 0.25  # dy
    offsets[..., 1::2] = -0.5  # dx
    idx, wgt = deform_conv.dcn_corner_tables(offsets, h, w)
    rows = idx.view(b, h * w, 9, 4)
    assert int(rows[0].max()) < h * w <= int(rows[1].min())
    inner = wgt.view(b, h, w, 9, 4)[:, 2:-2, 2:-2]
    torch.testing.assert_close(inner.sum(-1), torch.ones(inner.shape[:-1]))
    # tap 4 is the centre: (2 + 0.25, 3 - 0.5) has corners (2, 2), (2, 3),
    # (3, 2), (3, 3) with weights 0.75 * 0.5, 0.75 * 0.5, 0.25 * 0.5, ...
    centre = wgt.view(b, h, w, 9, 4)[1, 2, 3, 4]
    torch.testing.assert_close(centre, torch.tensor([0.375, 0.375, 0.125,
                                                     0.125]))
    corners = idx.view(b, h, w, 9, 4)[1, 2, 3, 4].tolist()
    assert corners == [h * w + 2 * w + 2, h * w + 2 * w + 3,
                       h * w + 3 * w + 2, h * w + 3 * w + 3]


def test_dcn_z_is_the_grouped_product():
    x, _, weights = _problem(3, 1, 3, 5, 16)
    z = deform_conv.dcn_z(torch.from_numpy(x), torch.from_numpy(weights), 4)
    xg = x.reshape(15, 4, 4)
    wg = weights.reshape(9, 4, 4, 4)
    want = np.einsum("ngi,tigo->tngo", xg, wg).reshape(9, 15, 16)
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-5, atol=1e-6)


def test_function_gradients_match_plain_autograd():
    """The autograd Function (on the CPU, forward through the plain
    gather) gives x, offsets and weights the gradients of autograd through
    the plain gather DCN; the offsets' gradient is real, not zero."""
    x, offsets, weights = (torch.from_numpy(a) for a in _problem(4))
    g = torch.from_numpy(np.random.RandomState(5).randn(2, 7, 9, 16)
                         .astype(np.float32))
    ins = [t.clone().requires_grad_() for t in (x, offsets, weights)]
    out = deform_conv.DeformConv2d.apply(*ins, 4)
    ref = [t.clone().requires_grad_() for t in (x, offsets, weights)]
    want = deform_conv.deform_conv2d_plain(*ref, groups=4)
    _close(out, want.detach().numpy())
    (out * g).sum().backward()
    (want * g).sum().backward()
    for got, exp in zip(ins, ref):
        _close(got.grad, exp.grad.numpy())
    assert float(ins[1].grad.abs().max()) > 0


def test_function_passes_only_the_gradients_asked_for():
    x, offsets, weights = (torch.from_numpy(a) for a in _problem(6))
    w = weights.clone().requires_grad_()
    out = deform_conv.DeformConv2d.apply(x, offsets, w, 4)
    out.sum().backward()
    assert w.grad is not None and float(w.grad.abs().max()) > 0


def test_cpu_route_is_plain_and_refuses_the_kernel():
    x, offsets, weights = (torch.from_numpy(a) for a in _problem(7))
    got = deform_conv.deform_conv2d(x, offsets, weights, groups=4)
    want = deform_conv.deform_conv2d_plain(x, offsets, weights, groups=4)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        deform_conv.deform_conv2d(x, offsets, weights, groups=4,
                                  use_kernel=True)
    with pytest.raises(ValueError, match="card"):
        deform_conv.dcn_gather_kernel(deform_conv.dcn_z(x, weights, 4),
                                      offsets)


def test_depth_net_plain_route_matches_jax(bridged):  # noqa: F811
    """The DepthNet with ``use_kernel=False`` (the DCN on its plain route)
    still matches the JAX DepthNet (test_torch_modules.py)."""
    from stereoscene_tpu.models.depth_net import DepthNet as JDepthNet
    from tests.test_models import TINY
    from tests.test_torch_modules import CAM, _check, _sub, japply

    model, _, params, stats = bridged
    x, _, ml, _ = _features(2, b=2)
    dn = model.img_view_transformer.depth_net
    vt = "img_view_transformer"
    jm = JDepthNet(mid_channels=x.shape[-1], context_channels=TINY.numC_Trans,
                   depth_channels=TINY.num_depth, cam_channels=CAM)
    want = japply(jm, {"params": params[vt]["depth_net"],
                       "batch_stats": _sub(stats, vt, "depth_net")},
                  jnp.asarray(x), jnp.asarray(ml), train=False)
    with torch.no_grad():
        got = dn(_nchw(x), torch.from_numpy(ml), use_kernel=False)
    _check(got.permute(0, 2, 3, 1), want)
    with pytest.raises(ValueError, match="CUDA"), torch.no_grad():
        dn(_nchw(x), torch.from_numpy(ml), use_kernel=True)
