"""Reference checkpoints into the port (``stereoscene_torch.utils.
convert_reference``, ``tools.convert_checkpoint``, ``tools.test.
load_checkpoint``) against the JAX package's converter.

The eight cases of tests/test_convert_reference.py, held to the port's own
keys: a state_dict that JAX's ``synthesize_state_dict(build_name_map(...))``
makes for the TINY detector loads strictly and round-trips exactly; an
unexpected key raises with the closest model key as a hint;
``num_batches_tracked`` and checkpoint bookkeeping are tolerated; a missing
key is named; a shape mismatch raises; fp16 values load as fp32 within
fp16 rounding; a checkpoint saved after ``fuse_conv_bn`` (one pair of each
naming pattern) loads with each BN the identity affine of its own eps;
ambiguous fused candidates raise and the BN width tells others apart.

Then the models: the port's seeded TINY weights, as a reference
state_dict in the layout of JAX's name map (its key set), go strictly
through JAX's ``convert_reference_checkpoint`` and through the port's
loader, plain and fused; the port's eval logits are within 2e-3 of
max|ref| of JAX's converted model (the model limit of
tests/test_torch_spatial.py), and the port's fused model within 1e-5 of
its unfused one. Last the CLI: ``--prefix`` strips a prefix, ``--no-strict``
converts a backbone-only file and reports what it left out, a strict run
of that file raises, and a ResNet3D depth that neither package builds
is refused by name (tests/test_torch_resnet3d_depths.py converts the
depths both build).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.efficientnet import scaled_stage_settings
from stereoscene_tpu.utils.convert_reference import (
    adapt_fused_state_dict as jax_adapt,
    build_name_map,
    convert_reference_checkpoint,
    synthesize_state_dict,
)
from stereoscene_torch.models.layers import BatchNorm
from stereoscene_torch.utils.convert_reference import (
    adapt_fused_state_dict,
    load_reference,
)
from tests.test_convert_reference import _torch_fuse
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import port_model
from tests.test_torch_train_cli import TINY_CFG

# one pair of each naming pattern (tests/test_convert_reference.py)
FUSED_PAIRS = (
    ("img_backbone.layers.0.conv", "img_backbone.layers.0.bn"),
    ("img_neck.deblocks.1.0", "img_neck.deblocks.1.1"),
    ("img_view_transformer.depth_net.depth_conv.0.conv1",
     "img_view_transformer.depth_net.depth_conv.0.bn1"),
    ("img_view_transformer.depth_net.depth_conv.0.conv2",
     "img_view_transformer.depth_net.depth_conv.0.bn2"),
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """(name map, zero params, zero stats) of JAX's TINY detector."""
    batch = _tiny_batch()
    shapes = jax.eval_shape(
        lambda k: JaxModel(cfg=TINY).init(k, batch, train=False),
        jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    _, stages, _ = scaled_stage_settings(TINY.backbone_arch)
    nm = build_name_map([len(s) for s in stages])
    return nm, zeros["params"], zeros["batch_stats"]


@pytest.fixture(scope="module")
def synthesized(jax_side):
    return synthesize_state_dict(*jax_side, seed=0)


def _model():
    return port_model(seed=1)


def test_synthesized_reference_loads_strictly_and_round_trips(synthesized):
    model = _model()
    assert load_reference(model, synthesized) == ([], [])
    own = model.state_dict()
    assert {k for k in own if not k.endswith("num_batches_tracked")} \
        == set(synthesized)
    for key, value in synthesized.items():
        assert torch.equal(own[key], torch.from_numpy(
            np.ascontiguousarray(value))), key


def test_unexpected_keys_raise_with_hint(synthesized):
    sd = dict(synthesized)
    sd["img_backbone.layers.0.conv.weightt"] = sd[
        "img_backbone.layers.0.conv.weight"]
    with pytest.raises(RuntimeError) as e:
        load_reference(_model(), sd)
    assert "weightt" in str(e.value)
    assert "closest model key: img_backbone.layers.0.conv.weight" \
        in str(e.value)


def test_num_batches_tracked_and_meta_tolerated(synthesized):
    sd = dict(synthesized)
    sd["img_backbone.layers.0.bn.num_batches_tracked"] = np.int64(1234)
    sd["meta.epoch"] = np.int64(3)
    load_reference(_model(), sd)


def test_missing_key_readable(synthesized):
    sd = dict(synthesized)
    del sd["img_backbone.layers.0.conv.weight"]
    with pytest.raises(RuntimeError, match="Missing key") as e:
        load_reference(_model(), sd)
    assert "img_backbone.layers.0.conv.weight" in str(e.value)


def test_shape_mismatch_raises(synthesized):
    sd = dict(synthesized)
    sd["img_backbone.layers.0.conv.weight"] = np.zeros((7, 3, 3, 3),
                                                       np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_reference(_model(), sd)


def test_fp16_checkpoint_roundtrips(synthesized):
    ref, half = _model(), _model()
    load_reference(ref, synthesized)
    load_reference(half, {k: np.asarray(v, np.float16)
                          for k, v in synthesized.items()})
    for key, want in ref.state_dict().items():
        got = half.state_dict()[key]
        assert got.dtype == want.dtype, key
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                                   atol=1e-3, err_msg=key)


def _fuse(sd, model):
    """Simulate the reference's fuse_conv_bn on FUSED_PAIRS with each BN's
    own eps; -> (fused sd, {bn key: (fused bias, eps)})."""
    sd = {k: np.array(v, np.float32) for k, v in sd.items()}
    modules = dict(model.named_modules())
    expected = {}
    for conv_key, bn_key in FUSED_PAIRS:
        eps = modules[bn_key].eps
        _, bias = _torch_fuse(sd, conv_key, bn_key, eps)
        expected[bn_key] = (bias, eps)
    return sd, expected


def test_fused_bn_checkpoint_roundtrips(synthesized):
    model = _model()
    rng = np.random.RandomState(42)
    sd = dict(synthesized)
    for _, bn_key in FUSED_PAIRS:
        n = sd[f"{bn_key}.running_var"].shape[0]
        sd[f"{bn_key}.running_mean"] = rng.randn(n).astype(np.float32)
        sd[f"{bn_key}.running_var"] = (rng.rand(n) + 0.5).astype(np.float32)
    fused, expected = _fuse(sd, model)
    assert load_reference(model, fused) == ([], [])
    own = model.state_dict()
    for bn_key, (bias, eps) in expected.items():
        n = bias.shape[0]
        assert eps in (1e-3, 1e-5)
        assert torch.equal(own[f"{bn_key}.weight"], torch.ones(n))
        np.testing.assert_allclose(own[f"{bn_key}.bias"].numpy(), bias,
                                   rtol=1e-6)
        assert torch.equal(own[f"{bn_key}.running_mean"], torch.zeros(n))
        assert torch.equal(own[f"{bn_key}.running_var"],
                           torch.full((n,), 1.0 - eps))


class _Siblings(torch.nn.Module):
    """Two bias-free convs and one BN of width 8 under module ``m``; the
    conv names carry no digit matching the BN's."""

    def __init__(self, width_a, width_b):
        super().__init__()
        self.m = torch.nn.Module()
        self.m.convA = torch.nn.Conv2d(3, width_a, 1, bias=False)
        self.m.convB = torch.nn.Conv2d(3, width_b, 1, bias=False)
        self.m.norm = BatchNorm(8)


def test_fused_bn_ambiguous_candidates_raise():
    def fused_sd(width_a, width_b):
        rng = np.random.RandomState(0)
        return {f"m.{c}.{p}": torch.from_numpy(rng.randn(
                    w, *((3, 1, 1) if p == "weight" else ())).astype(
                    np.float32))
                for c, w in (("convA", width_a), ("convB", width_b))
                for p in ("weight", "bias")}

    def targets(module):
        return {k: tuple(v.shape) for k, v in module.state_dict().items()}

    with pytest.raises(ValueError, match="ambiguous"):
        adapt_fused_state_dict(fused_sd(8, 8), targets(_Siblings(8, 8)),
                               lambda name: 1e-5)
    sd = fused_sd(8, 6)  # the width tells them apart
    out = adapt_fused_state_dict(sd, targets(_Siblings(8, 6)),
                                 lambda name: 1e-5)
    assert torch.equal(out["m.norm.bias"], sd["m.convA.bias"])
    assert "m.convB.bias" in out and "m.convA.bias" not in out


@pytest.fixture(scope="module")
def seeded_reference(jax_side):
    """The seeded TINY weights as a reference state_dict (numpy) in the
    layout of JAX's name map, and a batch."""
    nm, _, _ = jax_side
    known = {r[0] for r in nm.params.values()} | {
        r[0] for r in nm.stats.values()}
    sd = {k: v.numpy() for k, v in port_model(seed=9).state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert set(sd) == known
    return sd, _tiny_batch(rng=np.random.RandomState(4))


def _port_logits(sd, batch):
    model = _model()
    assert load_reference(model, sd) == ([], [])
    return model({k: torch.from_numpy(np.asarray(v))
                  for k, v in batch.items()})["output_voxels"].numpy()


def _jax_logits(jax_side, sd, batch, fused=False):
    nm, params, stats = jax_side
    if fused:
        sd = jax_adapt(sd, nm, target_stats=stats)
    p, s = convert_reference_checkpoint(sd, nm, params, stats, strict=True)
    out = JaxModel(cfg=TINY).apply({"params": p, "batch_stats": s},
                                   batch, train=False)
    return np.asarray(out["output_voxels"][0])


@pytest.mark.parametrize("fused", [False, True])
def test_reference_weights_match_jax_converted_model(jax_side,
                                                     seeded_reference,
                                                     fused):
    sd, batch = seeded_reference
    plain = _port_logits(sd, batch)
    if fused:
        sd, _ = _fuse(sd, _model())
    got = _port_logits(sd, batch)
    want = _jax_logits(jax_side, sd,
                       {k: jnp.asarray(v) for k, v in batch.items()}, fused)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-3 * scale
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


def test_convert_cli_prefix_and_no_strict(seeded_reference, tmp_path,
                                          capsys):
    from stereoscene_torch.tools import convert_checkpoint as cli
    from stereoscene_torch.tools.test import load_checkpoint

    sd, batch = seeded_reference
    src = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v)
                               for k, v in sd.items()}, "meta": {"epoch": 3}},
               src)
    out = str(tmp_path / "port.pth")
    assert cli.main([src, TINY_CFG, "--out", out, "--prefix", "module.",
                     "--device", "cpu"]) == ([], [])
    model = _model()
    load_checkpoint(model, out)
    for k, v in sd.items():
        assert np.array_equal(model.state_dict()[k].numpy(), v), k

    backbone = str(tmp_path / "backbone.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith("img_backbone.")}, backbone)
    with pytest.raises(RuntimeError, match="Missing key"):
        cli.main([backbone, TINY_CFG, "--out", out, "--device", "cpu"])
    missing, unexpected = cli.main([backbone, TINY_CFG, "--out", out,
                                    "--no-strict", "--device", "cpu"])
    assert missing and not unexpected
    assert not any(k.startswith("img_backbone.") for k in missing)
    assert f"{len(missing)} model keys not in the file" \
        in capsys.readouterr().out
    loaded = torch.load(out, weights_only=True)["state_dict"]
    for k, v in sd.items():
        if k.startswith("img_backbone."):
            assert np.array_equal(loaded[k].numpy(), v), k


def test_convert_cli_refuses_a_depth_the_port_does_not_build(tmp_path):
    from stereoscene_torch.tools import convert_checkpoint as cli

    # the port builds every depth the JAX package builds (10, 18, 34, 50,
    # 101); a depth of neither is refused by name
    cfg = tmp_path / "depth26.py"
    cfg.write_text(f"_base_ = [{TINY_CFG!r}]\n"
                   "model = dict(img_bev_encoder_backbone=dict(depth=26))\n")
    src = str(tmp_path / "empty.pth")
    torch.save({}, src)
    with pytest.raises(ValueError, match="CustomResNet3D depth 26"):
        cli.main([src, str(cfg), "--out", os.devnull, "--device", "cpu"])
