"""BatchNorm folding for inference (``stereoscene_torch.utils.fuse_bn`` and
``tools.fuse_conv_bn``) against the unfused port and the JAX package's
``fuse_conv_bn`` (tests/test_fuse_bn.py).

- ``ConvBNAct`` with non-trivial BN statistics: the fused module's eval
  output within 1e-4 of the unfused one (tests/test_fuse_bn.py's
  tolerance), one pair folded; its fused weights equal JAX's
  ``fuse_conv_bn`` on the same weights (eps 1e-3, the module's own) within
  1e-6 of scale, and its output JAX's fused module's within 1e-5 of
  max|ref|.
- The seeded TINY detector (eval mode): every EfficientNet ``ConvBNAct``
  folded, the fused model's logits and
  depth distribution within 1e-5 of max|ref| of the unfused model's; the
  CLI writes a checkpoint that the eval CLI's loader takes and that gives
  the same outputs.
- VoVNet's ``ConvBN`` (BN eps 1e-5): the port's fold within 1e-5 of
  max|ref| of the unfused module; JAX's one eps of 1e-3 applied to the
  same pair misses by far more, printed for ROADMAP Queue 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models.efficientnet import ConvBNAct as JConvBNAct
from stereoscene_tpu.utils.fuse_bn import fuse_conv_bn as jax_fuse
from stereoscene_torch.models.efficientnet import ConvBNAct
from stereoscene_torch.models.vovnet import ConvBN
from stereoscene_torch.utils.fuse_bn import conv_bn_pairs, fuse_conv_bn
from tests.test_models import _tiny_batch
from tests.test_torch_modules import port_model


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_bn(module, seed):
    """BN weight, bias and statistics away from their defaults."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(n, generator=gen))
                m.running_mean.copy_(torch.randn(n, generator=gen))
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


def _fused_copy(module, make):
    fused_sd, n = fuse_conv_bn(module)
    fused = make()
    fused.load_state_dict(fused_sd)
    return fused.eval(), n


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_fused_conv_bn_act_preserves_output():
    torch.manual_seed(0)
    mod = ConvBNAct(6, 8, 3)
    _randomize_bn(mod, 0)
    mod.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 6, 10, 4)
                         .astype(np.float32))
    fused, n = _fused_copy(mod, lambda: ConvBNAct(6, 8, 3))
    assert n == 1
    with torch.no_grad():
        np.testing.assert_allclose(fused(x).numpy(), mod(x).numpy(),
                                   atol=1e-4)
    bn = fused.bn
    assert torch.equal(bn.weight, torch.ones(8))
    assert torch.equal(bn.running_mean, torch.zeros(8))
    assert torch.equal(bn.running_var, torch.full((8,), 1.0 - 1e-3))


def test_fused_conv_bn_act_matches_jax_fuse():
    torch.manual_seed(1)
    mod = ConvBNAct(6, 8, 3)
    _randomize_bn(mod, 1)
    mod.eval()
    sd = {k: v.numpy() for k, v in mod.state_dict().items()}
    params = {"conv": {"kernel": sd["conv.weight"].transpose(2, 3, 1, 0)},
              "bn": {"BatchNorm_0": {"scale": sd["bn.weight"],
                                     "bias": sd["bn.bias"]}}}
    stats = {"bn": {"BatchNorm_0": {"mean": sd["bn.running_mean"],
                                    "var": sd["bn.running_var"]}}}
    jp, js, n = jax_fuse(params, stats, eps=1e-3)
    fused, n_port = _fused_copy(mod, lambda: ConvBNAct(6, 8, 3))
    assert n == n_port == 1
    fsd = {k: v.numpy() for k, v in fused.state_dict().items()}
    pairs = [(fsd["conv.weight"].transpose(2, 3, 1, 0), jp["conv"]["kernel"]),
             (fsd["bn.bias"], jp["bn"]["BatchNorm_0"]["bias"]),
             (fsd["bn.weight"], jp["bn"]["BatchNorm_0"]["scale"]),
             (fsd["bn.running_mean"], js["bn"]["BatchNorm_0"]["mean"]),
             (fsd["bn.running_var"], js["bn"]["BatchNorm_0"]["var"])]
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    x = np.random.RandomState(1).randn(2, 10, 4, 6).astype(np.float32)
    ref = JConvBNAct(features=8, kernel=3).apply(
        {"params": jp, "batch_stats": js}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = fused(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    ref = torch.from_numpy(np.array(ref).transpose(0, 3, 1, 2))
    assert _rel(got, ref) <= 1e-5


@pytest.fixture(scope="module")
def tiny():
    """The seeded TINY model (``seeded_init_`` sets every BN statistic
    away from its default) in eval mode and a batch. Its own fp32 outputs
    lie within 2e-6 of max|ref| of its float64 ones; BN weights and
    statistics drawn as ``_randomize_bn`` draws them take that to 2e-5,
    past the tolerance, for fused and unfused alike."""
    model = port_model(seed=3)
    assert all(float(m.running_mean.abs().max()) > 0 for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    model.eval()
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _tiny_batch(rng=np.random.RandomState(2)).items()}
    return model, batch


def test_fused_tiny_model_matches_unfused(tiny):
    model, batch = tiny
    fused, n = _fused_copy(model, lambda: port_model(seed=4))
    pairs = list(conv_bn_pairs(model))
    assert n == len(pairs) > 40
    assert all(name.startswith("img_backbone.") for name, _ in pairs)
    want, got = model(batch), fused(batch)
    for key in ("output_voxels", "depth_prob"):
        assert _rel(got[key], want[key]) <= 1e-5, key


def test_fuse_cli_writes_a_loadable_checkpoint(tiny, tmp_path, capsys):
    from stereoscene_torch.tools import fuse_conv_bn as fuse_cli
    from stereoscene_torch.tools.test import load_checkpoint
    from tests.test_torch_train_cli import TINY_CFG

    model, batch = tiny
    src, out = str(tmp_path / "in.pth"), str(tmp_path / "fused.pth")
    torch.save({"state_dict": model.state_dict()}, src)
    n = fuse_cli.main([src, TINY_CFG, "--out", out, "--device", "cpu"])
    assert f"fused {n} conv+bn pairs" in capsys.readouterr().out
    assert n == len(list(conv_bn_pairs(model)))
    loaded = port_model(seed=5)
    load_checkpoint(loaded, out)
    got, want = loaded.eval()(batch), model(batch)
    assert _rel(got["output_voxels"], want["output_voxels"]) <= 1e-5


def test_vovnet_pair_takes_its_own_eps():
    torch.manual_seed(2)
    mod = ConvBN(6, 8)
    _randomize_bn(mod, 2)
    mod.eval()
    assert mod.bn.eps == 1e-5
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 6, 9, 7)
                         .astype(np.float32))
    fused, n = _fused_copy(mod, lambda: ConvBN(6, 8))
    assert n == 1
    with torch.no_grad():
        want = mod(x)
        assert _rel(fused(x), want) <= 1e-5
    # the JAX package's fuse_conv_bn folds every pair with eps 1e-3
    sd = {k: v.numpy() for k, v in mod.state_dict().items()}
    params = {"conv": {"Conv_0": {
        "kernel": sd["conv.weight"].transpose(2, 3, 1, 0)}},
              "bn": {"BatchNorm_0": {"scale": sd["bn.weight"],
                                     "bias": sd["bn.bias"]}}}
    stats = {"bn": {"BatchNorm_0": {"mean": sd["bn.running_mean"],
                                    "var": sd["bn.running_var"]}}}
    jp, js, _ = jax_fuse(params, stats)
    jax_fused = ConvBN(6, 8).eval()
    jax_fused.load_state_dict({
        "conv.weight": torch.from_numpy(np.ascontiguousarray(
            jp["conv"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))),
        "bn.weight": torch.from_numpy(jp["bn"]["BatchNorm_0"]["scale"]),
        "bn.bias": torch.from_numpy(jp["bn"]["BatchNorm_0"]["bias"]),
        "bn.running_mean": torch.from_numpy(js["bn"]["BatchNorm_0"]["mean"]),
        "bn.running_var": torch.from_numpy(js["bn"]["BatchNorm_0"]["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    with torch.no_grad():
        err = _rel(jax_fused(x), want)
    print(f"JAX fuse_conv_bn (eps 1e-3) on VoVNet's ConvBN (BN eps 1e-5): "
          f"{err:.3e} of max|ref|")
    assert err > 1e-4
