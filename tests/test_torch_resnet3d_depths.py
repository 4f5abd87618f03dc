"""ResNet3D at depths 34, 50 and 101 (BasicBlock 34; Bottleneck 50 and 101,
4x wide) against the JAX package's ``CustomResNet3D``, weights carried by
``utils.weights.resnet3d_rules``.

- The module at TINY widths: forward within 1e-5 of max|ref|, every
  parameter gradient within max(2e-2 * leaf, 1e-5 * global scale) and the
  input gradient within 1e-5 of its scale, for a seeded cotangent.
- ``out_indices=(1, 2)`` returns the stages the JAX module returns.
- The TINY detector at depth 50 (its voxel neck on the 4x stages) end to
  end against JAX's, through ``flax_trees``: depth_prob within 2e-4, logits
  within 2e-3 of max|ref| (tests/test_full_model_parity.py's limits).
- ``tools.convert_checkpoint`` at depth 50: a reference file of the
  port's keys (``conv3`` / ``bn3`` in every block) round-trips exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.detector import DetectorConfig as JaxConfig
from stereoscene_tpu.models.resnet3d import CustomResNet3D as JaxResNet3D
from stereoscene_torch.models.detector import (BEVDepthOccupancy,
                                               DetectorConfig)
from stereoscene_torch.models.resnet3d import CustomResNet3D, stage_widths
from stereoscene_torch.utils import weights
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import japply

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(ROOT, "stereoscene_torch", "configs",
                        "stereoscene_tiny.py")
WIDTHS = TINY.voxel_channels  # (8, 16, 32)
STRIDES = (1, 2, 2)
GROUPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(depth, out_indices=(0, 1, 2)):
    """The JAX module and its variables, and the port's with its weights."""
    jm = JaxResNet3D(depth=depth, num_stage=3, block_inplanes=WIDTHS,
                     block_strides=STRIDES + (2,), out_indices=out_indices,
                     norm_groups=GROUPS)
    x = np.random.RandomState(depth).randn(2, 8, 8, 4, 6).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(depth), jnp.asarray(x))
    tm = CustomResNet3D(6, WIDTHS, STRIDES, depth=depth, norm_groups=GROUPS,
                        out_indices=out_indices)
    m = weights._Map()
    weights.resnet3d_rules(m, depth, WIDTHS, STRIDES)
    weights.load_rules(tm, m, jax.device_get(variables["params"]))
    return jm, variables, tm, m, x


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-12), (msg, err)


@pytest.mark.parametrize("depth", [34, 50, 101])
def test_depth_matches_jax_forward_and_gradients(depth):
    jm, variables, tm, m, x = _pair(depth)
    assert len(m.params) == sum(1 for _ in tm.parameters())
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    got = tm(xt)
    rng = np.random.RandomState(1)
    cots = [rng.randn(*o.permute(0, 2, 3, 4, 1).shape).astype(np.float32)
            for o in got]

    @jax.jit
    def jax_side(p, xx, c):
        outs, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx), p, xx)
        return outs, vjp(c)

    outs, (want_p, want_x) = jax_side(variables["params"], jnp.asarray(x),
                                      [jnp.asarray(c) for c in cots])
    widths = stage_widths(depth, WIDTHS)
    assert [o.shape[1] for o in got] == list(widths)
    for o, w in zip(got, outs):
        _close(o.detach().permute(0, 2, 3, 4, 1).numpy(), w, 1e-5, "out")
    params = [p for _, p in tm.named_parameters()]
    grads = torch.autograd.grad(
        sum((o * torch.from_numpy(c).permute(0, 4, 1, 2, 3)).sum()
            for o, c in zip(got, cots)), [xt] + params)
    _close(grads[0].permute(0, 2, 3, 4, 1).numpy(), want_x, 1e-5, "dx")
    got_p = weights.rules_trees(tm, m, dict(zip(
        [n for n, _ in tm.named_parameters()], grads[1:])))[0]
    flat_got = weights._flatten(got_p)
    flat_want = weights._flatten(jax.device_get(want_p))
    assert flat_got.keys() == flat_want.keys()
    scale = max(np.abs(v).max() for v in flat_want.values())
    for k, v in flat_want.items():
        leaf = max(np.abs(v).max(), 1e-12)
        err = np.abs(np.asarray(flat_got[k]) - v).max()
        assert err <= max(2e-2 * leaf, 1e-5 * scale), (k, err / leaf)


def test_out_indices_as_jax():
    jm, variables, tm, _, x = _pair(50, out_indices=(1, 2))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert len(got) == len(want) == 2
    for o, w in zip(got, want):
        _close(o.detach().permute(0, 2, 3, 4, 1).numpy(), w, 1e-5)


def test_depth50_detector_matches_jax():
    cfg = DetectorConfig(**{**dataclasses.asdict(TINY), "resnet_depth": 50})
    model = BEVDepthOccupancy(cfg, device="cpu")
    weights.seeded_init_(model, 7)
    assert model.img_bev_encoder_neck.deblocks[2][0].weight.shape[0] == 128
    params, stats = weights.flax_trees(model)
    batch = _tiny_batch(b=1, rng=np.random.RandomState(4))
    jm = JaxModel(cfg=JaxConfig(**dataclasses.asdict(cfg)))
    want = japply(jm, {"params": params, "batch_stats": stats}, batch,
                  train=False)
    got = model({k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    np.testing.assert_allclose(got["depth_prob"].numpy(),
                               np.asarray(want["depth_prob"]), atol=2e-4,
                               rtol=0)
    ref = np.asarray(want["output_voxels"][0])
    _close(got["output_voxels"].numpy(), ref, 2e-3, "logits")


def test_convert_checkpoint_round_trips_at_depth_50(tmp_path):
    from stereoscene_torch.tools import convert_checkpoint as cli
    from stereoscene_torch.tools.test import load_checkpoint

    cfg = tmp_path / "depth50.py"
    cfg.write_text(f"_base_ = [{TINY_CFG!r}]\n"
                   "model = dict(img_bev_encoder_backbone=dict(depth=50))\n")
    torch.manual_seed(3)
    det = DetectorConfig(**{**dataclasses.asdict(TINY), "resnet_depth": 50})
    src_model = BEVDepthOccupancy(det, device="cpu")
    weights.seeded_init_(src_model, 3)
    sd = src_model.state_dict()
    assert "img_bev_encoder_backbone.layers.2.5.conv3.weight" in sd
    assert "img_bev_encoder_backbone.layers.0.0.bn3.weight" in sd
    src = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               src)
    out = str(tmp_path / "port.pth")
    assert cli.main([src, str(cfg), "--out", out, "--prefix", "module.",
                     "--device", "cpu"]) == ([], [])
    from stereoscene_torch.config import Config

    model = BEVDepthOccupancy(DetectorConfig.from_config(
        Config.fromfile(str(cfg))), device="cpu")
    assert model.cfg.resnet_depth == 50
    load_checkpoint(model, out)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k
