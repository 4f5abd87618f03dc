"""The port's training step against the JAX package's at TINY.

One shared fixture holds the JAX side, jit-compiled twice: the detector's
training forward (loss terms and updated batch statistics), and one
function giving ``jax.grad`` of every submodule of the detector in
training mode (image encoder, stereo volume net, DepthNet, MIE, the voxel
encoder and head), which together own every parameter leaf. The port runs
the same weights (``flax_trees``) and numpy inputs. Both sides take the
same ASPP dropout mask from numpy (the only random draw at TINY, whose
drop path rate is 0).

The gradients are compared submodule by submodule because the whole
detector's gradient at TINY has kinks within reach of fp32 rounding: on
the port alone, changing some weights by one fp32 ulp moves 34 of 506
leaves' gradients by more than 2%, the worst by 14%
(tools/probe_torch_grad_kinks.py), while JAX and the port agree to ~1e-5
in the forward. Tolerances:

- loss terms rtol 2e-3; every gradient leaf within max(2e-2 * leaf
  scale, 1e-4 * global scale) (tests/test_grad_parity.py);
- the step: the port's parameters after ``make_train_step`` against the
  JAX package's optimizer (``create_train_state(...).tx``: clip, AdamW,
  schedule) applied to the gradients of that step, within 2.5e-7 (two fp32
  ulps at 1; a first step moves a parameter by about lr * sign(g) =
  1e-4); the
  BatchNorm statistics against the JAX training forward's, within 1e-4 of
  scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stereoscene_tpu.engine import train as jtrain
from stereoscene_tpu.models.depth_net import DepthNet as JDepthNet
from stereoscene_tpu.models.detector import BEVDepthOccupancy as JaxModel
from stereoscene_tpu.models.mie import VolumeInteraction as JVolumeInteraction
from stereoscene_tpu.models.stereo_volume import (
    GwcVolumeEncoder as JGwcVolumeEncoder,
)
from stereoscene_tpu.ops.voxel_pool import lift_splat as jlift_splat
from stereoscene_torch.engine import train as ttrain
from stereoscene_torch.models import layers
from stereoscene_torch.ops.voxel_pool import lift_splat
from stereoscene_torch.utils.weights import flax_name_map, flax_trees
from tests.test_models import TINY, _tiny_batch
from tests.test_torch_modules import port_model

LOSS_CFG = dict(downsample=TINY.downsample, dbound=TINY.dbound)
ASPP_SHAPE = (2, sum(TINY.neck_out_channels)) + TINY.feature_size
CAM = 30
VT = "img_view_transformer"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several pytest
    workers on the CPU at once, and a full torch thread pool in each makes
    the CPU's bf16 and conv kernels crawl (oversubscription)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _labeled_batch(rng):
    batch = dict(_tiny_batch(b=2, rng=rng))
    x, y, z = TINY.grid_shape
    h, w = TINY.input_size
    batch["gt_occ"] = np.where(
        rng.rand(2, 2 * x, 2 * y, 2 * z) < 0.1, 255,
        rng.randint(0, 20, (2, 2 * x, 2 * y, 2 * z))).astype(np.int32)
    batch["gt_depth"] = ((rng.rand(2, 2, h, w) < 0.07)
                         * (rng.rand(2, 2, h, w) * 7.5 + 2.1)
                         ).astype(np.float32)
    return {k: np.array(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _aspp_mask_patch(mp, mask):
    """Both sides draw the ASPP dropout mask from ``mask`` [B, C, H, W]."""

    def port_mask(shape, keep, generator, device):
        assert tuple(shape) == mask.shape and keep == 0.5
        return torch.from_numpy(mask).to(device)

    def jax_mask(key, p, shape):
        assert tuple(shape) == mask.transpose(0, 2, 3, 1).shape and p == 0.5
        return jnp.asarray(mask.transpose(0, 2, 3, 1))

    mp.setattr(layers, "keep_mask", port_mask)
    mp.setattr(jax.random, "bernoulli", jax_mask)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _module_inputs(rng):
    """Inputs (JAX layouts) and output cotangents of each submodule."""
    fh, fw = TINY.feature_size
    d, c = TINY.num_depth, sum(TINY.neck_out_channels)

    def n(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    vols = [np.exp(n(2, d, fh, fw)) for _ in range(2)]
    return dict(
        imgs=n(4, *TINY.input_size, 3), enc_cot=n(4, fh, fw, c),
        left=n(2, fh, fw, c), right=n(2, fh, fw, c), ml=n(2, CAM),
        mr=n(2, CAM), calib=np.full((2,), 20.0, np.float32),
        single_cot=n(2, d, fh, fw), multi_cot=n(2, d, fh, fw, 32),
        dn_cot=n(2, fh, fw, d + TINY.numC_Trans),
        vols=[v / v.sum(1, keepdims=True) for v in vols],
        vi_cot=n(2, d, fh, fw),
        vox=n(2, *TINY.grid_shape, TINY.numC_Trans),
        bev_cot=n(2, *TINY.grid_shape, 20))


def _jax_module_grads(params, stats, a):
    """jax.grad of <submodule output, cotangent> for every submodule."""
    jm = JaxModel(cfg=TINY)
    rngs = {"dropout": jax.random.PRNGKey(0)}

    def run(module, p, s, *args, **kw):
        out, _ = module.apply({"params": p, "batch_stats": s}, *args,
                              train=True, rngs=rngs, mutable=["batch_stats"],
                              **kw)
        return out

    def sub(tree, *path):
        for key in path:
            tree = tree.get(key, {})
        return tree

    def losses(p):
        whole = {"params": p, "batch_stats": stats}

        def encoder(pp):
            (left, right), _ = jm.apply(
                dict(whole, params=pp), jnp.asarray(a["imgs"]).reshape(
                    2, 2, *a["imgs"].shape[1:]).swapaxes(0, 1),
                method=lambda m, v: m.encode_images(v, train=True),
                rngs=rngs, mutable=["batch_stats"])
            return jnp.sum(jnp.concatenate([left, right]) * a["enc_cot"])

        def stereo(pp):
            out = run(JGwcVolumeEncoder(max_disp=TINY.num_depth,
                                        cam_channels=CAM),
                      pp, sub(stats, VT, "stereo_volume_net"),
                      *(jnp.asarray(a[k])
                        for k in ("left", "right", "ml", "mr", "calib")))
            return (jnp.sum(out["single_channel"] * a["single_cot"])
                    + jnp.sum(out["multi_channel"] * a["multi_cot"]))

        def depth(pp):
            out = run(JDepthNet(mid_channels=a["left"].shape[-1],
                                context_channels=TINY.numC_Trans,
                                depth_channels=TINY.num_depth,
                                cam_channels=CAM),
                      pp, sub(stats, VT, "depth_net"),
                      jnp.asarray(a["left"]), jnp.asarray(a["ml"]))
            return jnp.sum(out * a["dn_cot"])

        def mie(pp):
            out = run(JVolumeInteraction(attention_chunk=TINY.attention_chunk),
                      pp, sub(stats, VT, "volume_interaction"),
                      *(jnp.asarray(v) for v in a["vols"]))
            return jnp.sum(out * a["vi_cot"])

        def bev(pp):
            (head, _), _ = jm.apply(
                dict(whole, params=pp), jnp.asarray(a["vox"]),
                method=lambda m, v: m.bev_encode(v, train=True),
                rngs=rngs, mutable=["batch_stats"])
            return jnp.sum(head["output_voxels"][0] * a["bev_cot"])

        grads = {}
        enc = jax.grad(encoder)(p)
        for key in ("img_backbone", "img_neck"):
            grads[key] = enc[key]
        bevg = jax.grad(bev)(p)
        for key in ("img_bev_encoder_backbone", "img_bev_encoder_neck",
                    "pts_bbox_head"):
            grads[key] = bevg[key]
        grads[VT] = {
            "stereo_volume_net": jax.grad(stereo)(p[VT]["stereo_volume_net"]),
            "depth_net": jax.grad(depth)(p[VT]["depth_net"]),
            "volume_interaction": jax.grad(mie)(p[VT]["volume_interaction"]),
        }
        return grads

    return jax.jit(losses)(params)


def _port_module_grads(model, a):
    model.train()
    vt = model.img_view_transformer
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "vols"}

    def nchw(x):
        return x.permute(0, 3, 1, 2)

    imgs = t["imgs"].reshape(2, 2, *t["imgs"].shape[1:]).transpose(0, 1)
    left, right = model.encode_images(imgs)
    total = (torch.cat([left, right]).permute(0, 2, 3, 1)
             * t["enc_cot"]).sum()
    out = vt.stereo_volume_net(nchw(t["left"]), nchw(t["right"]), t["ml"],
                               t["mr"], t["calib"])
    total = total + (out["single_channel"] * t["single_cot"]).sum() + (
        out["multi_channel"].permute(0, 2, 3, 4, 1) * t["multi_cot"]).sum()
    dn = vt.depth_net(nchw(t["left"]), t["ml"])
    total = total + (dn.permute(0, 2, 3, 1) * t["dn_cot"]).sum()
    fused = vt.volume_interaction(*(torch.from_numpy(v) for v in a["vols"]))
    total = total + (fused * t["vi_cot"]).sum()
    logits = model.bev_encode(t["vox"].permute(0, 4, 1, 2, 3))
    total = total + (logits.permute(0, 2, 3, 4, 1) * t["bev_cot"]).sum()
    total.backward()
    grads, _ = flax_trees(model, {n: p.grad for n, p in
                                  model.named_parameters()
                                  if p.grad is not None})
    return grads


@pytest.fixture(scope="module")
def stepped():
    rng = np.random.RandomState(5)
    batch = _labeled_batch(rng)
    mask = rng.rand(*ASPP_SHAPE) < 0.5
    inputs = _module_inputs(rng)
    params, stats = flax_trees(port_model(seed=7))
    jm = JaxModel(cfg=TINY)
    loss_cfg = ttrain.LossConfig(**LOSS_CFG)

    def jax_forward(p, s, b):
        out, mutated = jm.apply({"params": p, "batch_stats": s}, b,
                                train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        losses = jtrain.compute_losses(out, b, jtrain.LossConfig(**LOSS_CFG))
        return losses, mutated["batch_stats"]

    with pytest.MonkeyPatch.context() as mp:
        _aspp_mask_patch(mp, mask)
        jlosses, jstats = jax.jit(jax_forward)(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()})
        jgrads = _jax_module_grads(params, stats, inputs)
        tgrads = _port_module_grads(port_model(seed=7), inputs)
        seen = []
        record = ttrain.apply_gradients
        mp.setattr(ttrain, "apply_gradients", lambda state, grads: (
            seen.append([g.clone() for g in grads]), record(state, grads)))
        model = port_model(seed=7)
        state, logs = ttrain.make_train_step(loss_cfg)(
            ttrain.create_train_state(model, device="cpu"),
            _torch_batch(batch))
    # the JAX package's optimizer on the port's gradients
    grads_flax, _ = flax_trees(model, {
        n: g for (n, _), g in zip(state.trainable, seen[0])})
    tx = jtrain.create_train_state(
        jm, {"params": params, "batch_stats": stats}).tx

    @jax.jit
    def jax_step(g, p):
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    params_t, stats_t = flax_trees(model)
    return dict(
        jlosses={k: float(v) for k, v in jlosses.items()},
        jgrads=_flat(jgrads), tgrads=_flat(tgrads),
        optax_params=_flat(jax_step(grads_flax, params)),
        params0=_flat(params), tparams=_flat(params_t),
        jstats=_flat(jstats), tstats=_flat(stats_t), stats0=_flat(stats),
        logs={k: float(v) for k, v in logs.items()}, updates=state.updates)


def test_loss_terms_match_jax(stepped):
    want = dict(stepped["jlosses"], loss_total=sum(
        stepped["jlosses"].values()))
    assert set(stepped["logs"]) == set(want)
    for key, value in stepped["logs"].items():
        np.testing.assert_allclose(value, want[key], rtol=2e-3, err_msg=key)


def test_every_grad_leaf_matches_jax(stepped):
    jg, tg = stepped["jgrads"], stepped["tgrads"]
    assert jg.keys() == tg.keys() == stepped["params0"].keys()
    assert len(jg) > 300
    scale = max(max(np.abs(g).max() for g in jg.values()),
                max(np.abs(g).max() for g in tg.values()))
    assert scale > 1e-2  # a degenerate grad field would hide bugs
    atol = 1e-4 * scale
    bad = []
    for key, want in jg.items():
        leaf = max(np.abs(want).max(), np.abs(tg[key]).max(), 1e-6)
        err = np.abs(tg[key] - want).max()
        if err > max(2e-2 * leaf, atol):
            bad.append((key, float(err / leaf), float(leaf)))
    assert not bad, f"{len(bad)} leaves off: {sorted(bad)[:8]}"


def test_step_matches_jax_optimizer(stepped):
    """Parameters after one port step equal the JAX package's optimizer
    applied to the same gradients; batch statistics equal the JAX
    training forward's."""
    assert stepped["updates"] == 1
    for key, want in stepped["optax_params"].items():
        got = stepped["tparams"][key]
        assert np.abs(want - stepped["params0"][key]).max() > 0, key
        np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7,
                                   err_msg=key)
    assert stepped["jstats"].keys() == stepped["tstats"].keys()
    for key, want in stepped["jstats"].items():
        assert not np.array_equal(want, stepped["stats0"][key]), key
        np.testing.assert_allclose(stepped["tstats"][key], want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_boundaries(warmup):
    kw = dict(milestones=(2, 3), warmup_steps=warmup)
    want = jtrain.step_lr_schedule(1e-4, 5, **kw)
    got = ttrain.step_lr_schedule(1e-4, 5, **kw)
    for count in (0, 1, 6, 7, 9, 10, 11, 14, 15, 16, 40):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)


@pytest.mark.parametrize("frozen_stages", [0, 1, 3])
def test_frozen_predicate_matches_jax(frozen_stages):
    want = jtrain.efficientnet_frozen_predicate(frozen_stages)
    got = ttrain.efficientnet_frozen_predicate(frozen_stages)
    rules = flax_name_map(TINY).params
    assert any(want(path) for path in rules) == (frozen_stages > 0)
    for path, (key, _, _) in rules.items():
        assert got(key) == want(path), (path, key)


def test_frozen_parameters_do_not_move():
    model = port_model(seed=3)
    state = ttrain.create_train_state(
        model, frozen_predicate=ttrain.efficientnet_frozen_predicate(2),
        device="cpu")
    stem = model.img_backbone.layers[0].conv.weight.detach().clone()
    head = model.img_backbone.layers[-1].conv.weight.detach().clone()
    batch = _torch_batch(_labeled_batch(np.random.RandomState(1)))
    ttrain.make_train_step(ttrain.LossConfig(**LOSS_CFG))(
        state, batch, torch.Generator().manual_seed(0))
    assert torch.equal(model.img_backbone.layers[0].conv.weight, stem)
    assert not torch.equal(model.img_backbone.layers[-1].conv.weight, head)


def test_accumulated_steps_make_one_update():
    """accumulate_steps=2 (optax MultiSteps): the first gradient leaves the
    parameters, the second applies one update with the mean of both."""
    grads = [[torch.randn(p.shape, generator=torch.Generator().manual_seed(
        i * 1000 + j)) for j, p in enumerate(port_model(seed=4).parameters())]
        for i in range(2)]
    plain = ttrain.create_train_state(port_model(seed=4), device="cpu")
    ttrain.apply_gradients(plain, [(a + b) / 2 for a, b in zip(*grads)])
    acc = ttrain.create_train_state(port_model(seed=4), accumulate_steps=2,
                                    device="cpu")
    before = [p.detach().clone() for _, p in acc.trainable]
    ttrain.apply_gradients(acc, grads[0])
    assert acc.updates == 0
    assert all(torch.equal(p, b) for (_, p), b in zip(acc.trainable, before))
    ttrain.apply_gradients(acc, grads[1])
    assert acc.updates == 1 and acc.step == 2
    for (name, p), (_, q) in zip(acc.trainable, plain.trainable):
        torch.testing.assert_close(p, q, rtol=0, atol=1e-7, msg=name)


def test_checkpointed_backbone_matches_plain():
    """with_cp recomputes each block with the same DropPath mask and
    updates the BatchNorm statistics once."""
    batch = _torch_batch(_labeled_batch(np.random.RandomState(3)))
    loss_cfg = ttrain.LossConfig(**LOSS_CFG)
    out = []
    for with_cp in (False, True):
        model = port_model(seed=5)
        ref = port_model(seed=5)
        model.img_backbone = type(model.img_backbone)(
            "b0", TINY.backbone_out_indices, 0.2, with_cp)
        model.img_backbone.load_state_dict(ref.img_backbone.state_dict())
        state = ttrain.create_train_state(model, device="cpu")
        total, _, grads = ttrain.loss_and_grads(
            state, batch, loss_cfg, generator=torch.Generator().manual_seed(9))
        out.append((total, grads, model.img_backbone.state_dict()))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=0)
    atol = 1e-5 * max(float(g.abs().max()) for g in out[0][1])
    for g1, g0 in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=atol)
    for key, value in out[0][2].items():
        torch.testing.assert_close(out[1][2][key], value, rtol=1e-6,
                                   atol=1e-7, msg=key)


def test_drop_path_statistics():
    """Rates rise linearly over the blocks to drop_path_rate (the JAX
    package's dprs); a mask keeps each sample with probability 1 - rate
    and scales the kept ones by 1 / (1 - rate), so the mean is kept."""
    backbone = port_model(seed=1).img_backbone
    blocks = [b for stage in backbone.layers[1:-1] for b in stage]
    assert all(b.drop_path_rate == 0.0 for b in blocks)
    backbone = type(backbone)("b0", TINY.backbone_out_indices, 0.2)
    rates = [b.drop_path_rate for stage in backbone.layers[1:-1]
             for b in stage]
    np.testing.assert_allclose(
        rates, [0.2 * i / (len(rates) - 1) for i in range(len(rates))])
    n = 20000
    gen = torch.Generator().manual_seed(0)
    keep = layers.keep_mask((n,), 0.8, gen, torch.device("cpu"))
    assert abs(float(keep.float().mean()) - 0.8) < 4 * (0.16 / n) ** 0.5
    x = torch.ones(n, 3, 2, 2)
    y = layers.drop_path(x, keep, 0.2)
    torch.testing.assert_close(y[keep], x[keep] / 0.8)
    assert not y[~keep].any()
    assert abs(float(y.mean()) - 1.0) < 4 * (0.25 / n) ** 0.5
    block = next(b for b in blocks if b.with_res)
    backbone.eval()
    assert all(b.drop_mask(x, gen) is None for stage in backbone.layers[1:-1]
               for b in stage)
    assert block.drop_mask(x, gen) is None  # rate 0


def test_dynamic_lift_splat_matches_jax():
    rng = np.random.RandomState(6)
    b, d, fh, fw, c = 2, 5, 4, 6, 8
    grid = (4, 3, 2)
    nvox = int(np.prod(grid))
    dp = rng.rand(b, d, fh, fw).astype(np.float32)
    feat = rng.randn(b, fh, fw, c).astype(np.float32)
    ranks = rng.randint(0, nvox + 1, (b, d * fh * fw)).astype(np.int32)
    want = np.asarray(jlift_splat(jnp.asarray(dp), jnp.asarray(feat),
                                  jnp.asarray(ranks), grid))
    args = [torch.from_numpy(a) for a in (dp, feat)]
    for a in args:
        a.requires_grad_()
    got = lift_splat(*args, torch.from_numpy(ranks), grid)
    assert (ranks == nvox).any()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    got.sum().backward()
    assert all(torch.isfinite(a.grad).all() for a in args)


def test_bf16_policy_keeps_fp32_masters():
    model = port_model(seed=6)
    state = ttrain.create_train_state(model, device="cpu")
    batch = _torch_batch(_labeled_batch(np.random.RandomState(4)))
    total, losses, grads = ttrain.loss_and_grads(
        state, batch, ttrain.LossConfig(**LOSS_CFG), bf16=True,
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(total)
    assert all(g.dtype == torch.float32 for g in grads)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert sum(float(g.abs().sum()) > 0 for g in grads) > 0.9 * len(grads)
