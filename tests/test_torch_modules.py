"""The port's modules against the JAX package's, one module at a time.

Weights cross the weight bridge: the port's TINY detector gets seeded
weights (``seeded_init_``: nonzero BRI ``gamma`` / CA3D ``alpha`` and DCN
offset head), its ``state_dict`` goes through the JAX package's reference
converter into flax trees, and each JAX submodule runs with its subtree.
Inputs come from numpy seeds. fp32 within 1e-4 of the output's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models.depth_net import DepthNet as JDepthNet
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.efficientnet import scaled_stage_settings
from stereoscene_tpu.models.mie import VolumeInteraction as JVolumeInteraction
from stereoscene_tpu.models.stereo_volume import (
    GwcVolumeEncoder as JGwcVolumeEncoder,
)
from stereoscene_tpu.ops.resize import resize_trilinear as jresize
from stereoscene_tpu.utils.convert_reference import (
    build_name_map,
    convert_reference_checkpoint,
)
from stereoscene_torch.models.detector import BEVDepthOccupancy, DetectorConfig
from stereoscene_torch.ops.resize import resize_trilinear
from stereoscene_torch.utils.weights import seeded_init_
from tests.test_models import TINY, _tiny_batch

CAM = 30


def port_model(seed=7, **kwargs):
    model = BEVDepthOccupancy(DetectorConfig(**dataclasses.asdict(TINY)),
                              device="cpu", **kwargs)
    seeded_init_(model, seed)
    return model


def to_flax(model, jax_model, batch):
    """The port's weights as the JAX package's (params, batch_stats), via
    its reference-checkpoint converter (strict both ways)."""
    shapes = jax.eval_shape(
        lambda k: jax_model.init(k, batch, train=False), jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    _, stages, _ = scaled_stage_settings(TINY.backbone_arch)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return convert_reference_checkpoint(
        sd, build_name_map([len(s) for s in stages]), zeros["params"],
        zeros["batch_stats"])


@pytest.fixture(scope="module")
def bridged():
    model = port_model()
    jax_model = JaxModel(cfg=TINY)
    params, stats = to_flax(model, jax_model, _tiny_batch())
    return model, jax_model, params, stats


def japply(module, variables, *args, **kwargs):
    """``module.apply`` under ``jax.jit``: one XLA compile instead of one
    per primitive, several times faster at these sizes on the CPU."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        variables, *args)


def _sub(tree, *path):
    for key in path:
        tree = tree.get(key, {})
    return tree


def _check(got: torch.Tensor, want, tol=1e-4):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err:.3e} vs scale {scale:.3e}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _backbone_input():
    rng = np.random.RandomState(11)
    return rng.randn(2, *TINY.input_size, 3).astype(np.float32)


def test_efficientnet_b0(bridged):
    model, jm, params, stats = bridged
    x = _backbone_input()
    want = japply(jm, {"params": params, "batch_stats": stats},
                  jnp.asarray(x),
                  method=lambda m, v: m.img_backbone(v, train=False))
    with torch.no_grad():
        got = model.img_backbone(_nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _check(g.permute(0, 2, 3, 1), w)


def test_second_fpn(bridged):
    model, jm, params, stats = bridged
    x = _backbone_input()
    with torch.no_grad():
        feats = model.img_backbone(_nchw(x))
        got = model.img_neck(feats)
    want = japply(
        jm, {"params": params, "batch_stats": stats},
        [jnp.asarray(f.permute(0, 2, 3, 1).numpy()) for f in feats],
        method=lambda m, v: m.img_neck(v, train=False))
    _check(got.permute(0, 2, 3, 1), want)


def _features(seed, b=1):
    rng = np.random.RandomState(seed)
    fh, fw = TINY.feature_size
    c = sum(TINY.neck_out_channels)
    return (rng.randn(b, fh, fw, c).astype(np.float32),
            rng.randn(b, fh, fw, c).astype(np.float32),
            rng.randn(b, CAM).astype(np.float32),
            rng.randn(b, CAM).astype(np.float32))


@pytest.mark.parametrize("calib", [20.0, 707.0 * 0.54])
def test_gwc_volume_encoder(bridged, calib):
    model, _, params, stats = bridged
    left, right, ml, mr = _features(1)
    cal = np.full((1,), calib, np.float32)
    vt = "img_view_transformer"
    jm = JGwcVolumeEncoder(max_disp=TINY.num_depth, cam_channels=CAM)
    want = japply(
        jm, {"params": params[vt]["stereo_volume_net"],
         "batch_stats": _sub(stats, vt, "stereo_volume_net")},
        *(jnp.asarray(a) for a in (left, right, ml, mr, cal)), train=False)
    with torch.no_grad():
        got = model.img_view_transformer.stereo_volume_net(
            _nchw(left), _nchw(right), torch.from_numpy(ml),
            torch.from_numpy(mr), torch.from_numpy(cal))
    _check(got["single_channel"], want["single_channel"])
    _check(got["multi_channel"].permute(0, 2, 3, 4, 1), want["multi_channel"])


def test_depth_net_with_dcn_offsets(bridged):
    model, _, params, stats = bridged
    x, _, ml, _ = _features(2, b=2)
    dn = model.img_view_transformer.depth_net
    with torch.no_grad():
        offsets = dn.depth_conv[4].conv_offset(_nchw(x))
    assert float(offsets.abs().max()) > 0.05  # the DCN really deforms
    vt = "img_view_transformer"
    jm = JDepthNet(mid_channels=x.shape[-1], context_channels=TINY.numC_Trans,
                   depth_channels=TINY.num_depth, cam_channels=CAM)
    want = japply(
        jm, {"params": params[vt]["depth_net"],
         "batch_stats": _sub(stats, vt, "depth_net")},
        jnp.asarray(x), jnp.asarray(ml), train=False)
    with torch.no_grad():
        got = dn(_nchw(x), torch.from_numpy(ml))
    _check(got.permute(0, 2, 3, 1), want)


def test_volume_interaction(bridged):
    model, _, params, stats = bridged
    vi = model.img_view_transformer.volume_interaction
    assert vi.CA3D.alpha.item() != 0.0 and vi.lss2stereo.gamma.item() != 0.0
    rng = np.random.RandomState(3)
    d, (fh, fw) = TINY.num_depth, TINY.feature_size
    vols = [jax.nn.softmax(jnp.asarray(
        rng.randn(1, d, fh, fw).astype(np.float32) * 2), axis=1)
        for _ in range(2)]
    vt = "img_view_transformer"
    jm = JVolumeInteraction(attention_chunk=TINY.attention_chunk)
    want = japply(
        jm, {"params": params[vt]["volume_interaction"],
         "batch_stats": _sub(stats, vt, "volume_interaction")},
        *vols, train=False)
    with torch.no_grad():
        got = vi(*(torch.from_numpy(np.asarray(v)) for v in vols))
    _check(got, want)


def test_resnet3d_fpn3d_occhead(bridged):
    model, jm, params, stats = bridged
    rng = np.random.RandomState(4)
    vox = rng.randn(2, *TINY.grid_shape, TINY.numC_Trans).astype(np.float32)
    head_out, _ = japply(jm, {"params": params, "batch_stats": stats},
                         jnp.asarray(vox), method="bev_encode")
    with torch.no_grad():
        got = model.bev_encode(torch.from_numpy(vox).permute(0, 4, 1, 2, 3))
    _check(got.permute(0, 2, 3, 4, 1), head_out["output_voxels"][0])


@pytest.mark.parametrize("out_xyz", [(16, 16, 8), (32, 32, 16), (12, 20, 5)])
def test_resize_trilinear(out_xyz):
    """Exact 2x (the JAX stencil), 4x (jax.image.resize, as the flagship
    64x64x8 -> 256x256x32 upsample) and uneven factors."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 4, 20).astype(np.float32)
    want = jresize(jnp.asarray(x), out_xyz)
    got = resize_trilinear(torch.from_numpy(x), out_xyz)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
