"""The port's Mask2Former occupancy head against the JAX package's at TINY:
``sine_pos_embed_3d``, the flax-eps norms, flax's multi-head attention,
the 3D deformable encoder layer (nonzero sampling offsets), the pixel
decoder with and without its FPN branch, the masked cross-attention with a
fully masked query, the decoder layer, ``hungarian_match``,
``mask_match_cost``, the loss, ``semantic_inference`` and the whole head
(forward, every layer's attention mask, the loss over every layer and its
gradients), and the weights carried both ways.

Weights come from ``seeded_init_`` (sampling offsets and attention
weights nonzero) and cross as flax trees (``module_rules`` /
``flax_trees``). Tolerances: fp32 modules within 1e-5 of their output's
scale, 1e-4 after a softmax or a norm; the whole head within 2e-3 of
max|ref|, loss terms rtol 2e-3; gradient leaves within 2% with an atol
floor of 1e-4 x the global gradient scale.

Discrete steps are held with margins: the whole head's resampled mask
logits lie at least 1e-4 of their scale from the threshold 0 (so both
sides mask the same voxels), and every Hungarian assignment compared is
unchanged under a perturbation of 1e-4 of the cost's scale.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereoscene_tpu.models import mask2former_occ as jm
from stereoscene_tpu.ops.resize import resize_trilinear as jresize
from stereoscene_torch.models import mask2former_occ as tm
from stereoscene_torch.models.vit import Attention
from stereoscene_torch.utils.weights import (
    _flatten,
    flax_template,
    flax_trees,
    load_flax_params,
    module_rules,
    rules_trees,
    seeded_init_,
)
from torch_parity import close, distinct_tree, grads_close, port_grads

HEAD = dict(num_queries=8, embed_dim=16, num_layers=3, num_classes=5,
            num_heads=4, num_feat_levels=2, num_encoder_layers=2)
VOL = (2, 8, 8, 4, 12)
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("channels", [16, 20, 7])
def test_sine_pos_embed_matches_jax(channels):
    want = jm.sine_pos_embed_3d((5, 3, 4), channels)
    got = tm.sine_pos_embed_3d((5, 3, 4), channels)
    assert got.shape == (5, 3, 4, channels)
    close(got, want, 1e-5)


def test_group_norm_matches_flax():
    """flax's GroupNorm (eps 1e-6) on a channels-last volume of variance
    1e-6, where an eps of 1e-5 would show."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 4, 3, 2, 16) * 1e-3).astype(np.float32)
    port = tm.GroupNorm32(4, 16)
    seeded_init_(port, 0)
    jmod = fnn.GroupNorm(num_groups=4, dtype=jnp.float32)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), x)["params"])
    want = jmod.apply({"params": rules_trees(port, rules)[0]}, x)
    close(port(_t(x)), want, 1e-4)
    wrong = torch.nn.functional.group_norm(
        _t(x).permute(0, 4, 1, 2, 3), 4, port.weight, port.bias, 1e-5)
    assert np.abs(wrong.permute(0, 2, 3, 4, 1).detach().numpy()
                  - np.asarray(want)).max() > 1e-2


def test_multi_head_attention_matches_flax():
    """``vit.Attention`` on distinct query, key and value inputs, as the
    decoder layers call it: (q + pos, q + pos, q)."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 6, 16).astype(np.float32)
    k = rng.randn(2, 9, 16).astype(np.float32)
    v = rng.randn(2, 9, 16).astype(np.float32)
    port = Attention(16, 4)
    seeded_init_(port, 1)
    jmod = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=16)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), q, k,
                                         v)["params"])
    want = jmod.apply({"params": rules_trees(port, rules)[0]}, q, k, v)
    close(port(_t(q), _t(k), _t(v)), want, 1e-4)


def test_deformable_encoder_layer_matches_jax():
    rng = np.random.RandomState(2)
    shapes = [(4, 4, 2), (2, 2, 1)]
    v = sum(int(np.prod(s)) for s in shapes)
    tokens = rng.randn(2, v, 16).astype(np.float32)
    pos = rng.randn(v, 16).astype(np.float32)
    ref = rng.rand(v, 3).astype(np.float32)
    port = tm.DeformableEncoderLayer3D(16, 4, 3, 2)
    assert not port.sampling_offsets.weight.any()  # JAX's zero init
    seeded_init_(port, 2)
    assert port.sampling_offsets.weight.abs().min() > 0
    jmod = jm.DeformableEncoderLayer3D(16, 4, 3, 2)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), tokens, pos,
                                         ref, shapes)["params"])
    params = rules_trees(port, rules)[0]
    cot = rng.randn(*tokens.shape).astype(np.float32)

    def jloss(p, x):
        out = jmod.apply({"params": p}, x, pos, ref, shapes)
        return jnp.sum(out * cot), out

    (_, want), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, tokens)
    x = _t(tokens).requires_grad_()
    got = port(x, _t(pos), _t(ref), shapes)
    close(got, want, 1e-4)
    (got * _t(cot)).sum().backward()
    close(x.grad, jdx, 1e-4)
    grads_close(port_grads(port, rules), jgrads)


@pytest.mark.parametrize("levels", ["single", "fpn"])
def test_pixel_decoder_matches_jax(levels):
    """Two levels, both encoded; or three levels of different widths, the
    lowest two encoded and the high-res one fused by the FPN branch."""
    rng = np.random.RandomState(3)
    if levels == "single":
        chans, shapes = [12, 12], [(6, 4, 4), (3, 2, 2)]
    else:
        chans, shapes = [6, 8, 10], [(8, 8, 4), (4, 4, 2), (2, 2, 1)]
    feats = [rng.randn(2, *s, c).astype(np.float32)
             for s, c in zip(shapes, chans)]
    port = tm.OccPixelDecoder3D(chans, 16, 16, 2, 2, num_heads=4)
    seeded_init_(port, 3)
    jmod = jm.OccPixelDecoder3D(feat_channels=16, out_channels=16,
                                num_encoder_levels=2, num_encoder_layers=2,
                                num_heads=4)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0),
                                         feats)["params"])
    params = rules_trees(port, rules)[0]
    cot = rng.randn(2, *shapes[0], 16).astype(np.float32)

    def jloss(p):
        mf, outs = jmod.apply({"params": p}, feats)
        return jnp.sum(mf * cot), (mf, outs)

    (_, (want, wouts)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    got, outs = port([_t(f) for f in feats])
    close(got, want, 1e-4)
    assert len(outs) == len(wouts) == len(shapes)
    for g, w in zip(outs, wouts):
        close(g, w, 1e-4)
    (got * _t(cot)).sum().backward()
    grads_close(port_grads(port, rules), jgrads)


def test_masked_cross_attention_matches_jax():
    """A mask with one query masked everywhere (it attends everywhere)
    and one masked nowhere; gradients into every input."""
    rng = np.random.RandomState(4)
    q, qp = (rng.randn(2, 5, 16).astype(np.float32) for _ in range(2))
    f, fp = (rng.randn(2, 12, 16).astype(np.float32) for _ in range(2))
    mask = rng.rand(2, 5, 12) < 0.5
    mask[0, 1] = True
    mask[1, 3] = False
    port = tm.MaskedCrossAttention(16, 4)
    seeded_init_(port, 4)
    jmod = jm.MaskedCrossAttention(16, 4)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), q, qp, f, fp,
                                         mask)["params"])
    params = rules_trees(port, rules)[0]
    cot = rng.randn(2, 5, 16).astype(np.float32)

    def jloss(p, *x):
        out = jmod.apply({"params": p}, *x, mask)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(params, q, qp, f, fp)
    xs = [_t(a).requires_grad_() for a in (q, qp, f, fp)]
    got = port(*xs, _t(mask))
    close(got, want, 1e-4)
    (got * _t(cot)).sum().backward()
    for x, g in zip(xs, jgrads[1:]):
        close(x.grad, g, 1e-4)
    grads_close(port_grads(port, rules), jgrads[0])


def test_decoder_layer_matches_jax():
    rng = np.random.RandomState(5)
    q, qp = (rng.randn(2, 5, 16).astype(np.float32) for _ in range(2))
    f, fp = (rng.randn(2, 12, 16).astype(np.float32) for _ in range(2))
    mask = rng.rand(2, 5, 12) < 0.4
    port = tm.DecoderLayer(16, 4)
    seeded_init_(port, 5)
    jmod = jm.DecoderLayer(16, 4)
    rules = module_rules(port, jmod.init(jax.random.PRNGKey(0), q, qp, f, fp,
                                         mask)["params"])
    params = rules_trees(port, rules)[0]
    cot = rng.randn(2, 5, 16).astype(np.float32)

    def jloss(p):
        out = jmod.apply({"params": p}, q, qp, f, fp, mask)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    got = port(_t(q), _t(qp), _t(f), _t(fp), _t(mask))
    close(got, want, 1e-4)
    (got * _t(cot)).sum().backward()
    grads_close(port_grads(port, rules), jgrads)


def _stable_assignment(cost):
    """The assignment of ``cost``, checked unchanged under a perturbation
    of 1e-4 of its scale (padded targets' 1e4 penalty left out of it)."""
    cost = np.asarray(cost, np.float32)
    assign = tm.hungarian_match(_t(cost)).numpy()
    noise = np.random.RandomState(0).randn(*cost.shape).astype(np.float32)
    shaken = cost + MARGIN * np.abs(cost[cost < 1e3]).max() * noise
    np.testing.assert_array_equal(tm.hungarian_match(_t(shaken)).numpy(),
                                  assign)
    return assign


@pytest.mark.parametrize("shape", [(2, 6, 6), (2, 7, 3), (1, 3, 5)])
def test_hungarian_match_matches_jax(shape):
    """Square, more queries than targets (-1 for the unmatched) and more
    targets than queries; the port returns int64 on the cost's device."""
    cost = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    want = np.asarray(jm.hungarian_match(jnp.asarray(cost)))
    got = tm.hungarian_match(_t(cost).requires_grad_())
    assert got.dtype == torch.int64 and not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _stable_assignment(cost))
    assert ((got >= 0).sum(1) == min(shape[1:])).all()


def _targets(rng, b, t, shape, classes):
    masks = (rng.rand(b, t, *shape) < 0.3).astype(np.float32)
    labels = rng.randint(0, classes, (b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[0, -1] = False  # a padded slot
    return masks, labels, valid


def test_mask_match_cost_matches_jax():
    rng = np.random.RandomState(6)
    cls = rng.randn(2, 6, 6).astype(np.float32)
    logits = (rng.randn(2, 6, 40) * 3).astype(np.float32)
    masks, labels, _ = _targets(rng, 2, 4, (40,), 5)
    want = jm.mask_match_cost(jnp.asarray(cls), jnp.asarray(logits),
                              jnp.asarray(masks), jnp.asarray(labels))
    got = tm.mask_match_cost(_t(cls), _t(logits), _t(masks), _t(labels))
    close(got, want, 1e-5)


def test_mask2former_loss_matches_jax():
    """One layer's loss and its gradients into the logits, the padded
    target slot included."""
    rng = np.random.RandomState(7)
    b, qn, t, shape = 2, 6, 4, (4, 4, 2)
    cls = (rng.randn(b, qn, 6) * 2).astype(np.float32)
    logits = (rng.randn(b, qn, *shape) * 3).astype(np.float32)
    masks, labels, valid = _targets(rng, b, t, shape, 5)
    cost = jm.mask_match_cost(
        jnp.asarray(cls), jnp.asarray(logits.reshape(b, qn, -1)),
        jnp.asarray(masks.reshape(b, t, -1)), jnp.asarray(labels)) \
        + 1e4 * (~valid)[:, None]
    _stable_assignment(cost)

    def jtotal(c, m):
        losses = jm.mask2former_loss({"cls_logits": c, "mask_logits": m},
                                     masks, labels, valid)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True))(cls, logits)
    tc, tl = _t(cls).requires_grad_(), _t(logits).requires_grad_()
    got = tm.mask2former_loss({"cls_logits": tc, "mask_logits": tl},
                              _t(masks), _t(labels), _t(valid))
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_allclose(float(value.detach()), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    sum(got.values()).backward()
    close(tc.grad, jgrads[0], 1e-5)
    close(tl.grad, jgrads[1], 1e-5)


def test_semantic_inference_matches_jax():
    rng = np.random.RandomState(8)
    cls = rng.randn(2, 5, 6).astype(np.float32)
    logits = rng.randn(2, 5, 3, 4, 2).astype(np.float32)
    want = jm.semantic_inference(jnp.asarray(cls), jnp.asarray(logits))
    got = tm.semantic_inference(_t(cls), _t(logits))
    assert got.shape == (2, 3, 4, 2, 5)
    close(got, want, 1e-5)


def _attn_masks(out, level_shapes, b, qn, vol):
    """The attention mask each decoder layer saw, from the head's outputs:
    layer i's mask is layer i-1's prediction resampled to layer i's level
    (and the resampled logits, for the margin)."""
    preds = [m for _, m in out["aux"]]
    masks, values = [], []
    for i, m in enumerate(preds):
        shape = level_shapes[i % len(level_shapes)]
        r = np.asarray(jresize(
            jnp.asarray(np.asarray(m).reshape(b, qn, *vol, 1)), shape))
        values.append(r[..., 0])
        masks.append((r[..., 0] < 0).reshape(b, qn, -1))
    return masks, values


@pytest.fixture(scope="module")
def whole():
    """The port's and the JAX package's head at TINY on one volume (two
    pooled levels, three decoder layers: level 0, 1, 0) with the same
    weights: forward, the loss over every layer and its gradients."""
    rng = np.random.RandomState(9)
    x = rng.randn(*VOL).astype(np.float32)
    vol = VOL[1:4]
    masks, labels, valid = _targets(rng, 2, 4, vol, 5)
    port = tm.Mask2FormerOccHead(VOL[-1], device="cpu", **HEAD)
    seeded_init_(port, 9)
    params, _ = flax_trees(port)
    jmod = jm.Mask2FormerOccHead(**HEAD)

    def jloss(p):
        out = jmod.apply({"params": p}, x)
        losses = jm.mask2former_loss_all_layers(out, masks, labels, valid)
        return sum(losses.values()), (out, losses)

    (_, (jout, jlosses)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)

    seen = []
    hooks = [getattr(port, f"layer{i}").cross_attn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[-1]))
        for i in range(HEAD["num_layers"])]
    out = port(_t(x))
    for h in hooks:
        h.remove()
    losses = tm.mask2former_loss_all_layers(out, _t(masks), _t(labels),
                                            _t(valid))
    sum(losses.values()).backward()
    return dict(x=x, out=out, jout=jout, losses=losses, jlosses=jlosses,
                grads=flax_trees(port, {n: p.grad for n, p in
                                        port.named_parameters()
                                        if p.grad is not None})[0],
                jgrads=jgrads, params=params, port=port, seen=seen,
                targets=(masks, labels, valid))


def test_head_forward_matches_jax(whole):
    got, want = whole["out"], whole["jout"]
    assert got["cls_logits"].shape == (2, 8, 6)
    assert got["mask_logits"].shape == (2, 8) + VOL[1:4]
    assert len(got["aux"]) == len(want["aux"]) == HEAD["num_layers"]
    close(got["cls_logits"], want["cls_logits"], 2e-3)
    close(got["mask_logits"], want["mask_logits"], 2e-3)
    for (gc, gm), (wc, wm) in zip(got["aux"], want["aux"]):
        close(gc, wc, 2e-3)
        close(gm, wm, 2e-3)


def test_head_attention_masks_match_jax(whole):
    """Each layer's attention mask is the same on both sides: the
    resampled logits keep a margin of 1e-4 of their scale from 0, and the
    masks are detached. The seed's masks hold masked and unmasked voxels
    and queries masked everywhere (the fallback to unmasked attention)."""
    b, qn = 2, HEAD["num_queries"]
    vol = VOL[1:4]
    half = tuple(n // 2 for n in vol)
    want, values = _attn_masks(whole["jout"], [half, vol], b, qn, vol)
    seen = whole["seen"]
    assert len(seen) == len(want) == HEAD["num_layers"]
    for got, w, v in zip(seen, want, values):
        assert np.abs(v).min() > MARGIN * np.abs(v).max()
        assert not got.requires_grad and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), w)
    assert any(0 < w.mean() < 1 for w in want)
    assert any(w.all(-1).any() for w in want)


def test_head_loss_and_gradients_match_jax(whole):
    """Every layer's terms (``_aux{i}`` for the auxiliary ones), each
    layer's assignment held with a margin, and every gradient leaf."""
    got, want = whole["losses"], whole["jlosses"]
    assert got.keys() == want.keys()
    assert len(got) == 3 * (HEAD["num_layers"] + 1)
    masks, labels, valid = whole["targets"]
    b, qn = 2, HEAD["num_queries"]
    preds = list(whole["jout"]["aux"]) + [(whole["jout"]["cls_logits"],
                                           whole["jout"]["mask_logits"])]
    for cls, m in preds:
        cost = jm.mask_match_cost(cls, jnp.reshape(m, (b, qn, -1)),
                                  masks.reshape(b, 4, -1), labels) \
            + 1e4 * (~valid)[:, None]
        _stable_assignment(cost)
    for key, value in got.items():
        np.testing.assert_allclose(float(value.detach()), float(want[key]),
                                   rtol=2e-3, err_msg=key)
    grads_close(whole["grads"], whole["jgrads"])


def test_head_semantic_inference(whole):
    out = whole["out"]
    sem = tm.semantic_inference(out["cls_logits"], out["mask_logits"])
    want = jm.semantic_inference(whole["jout"]["cls_logits"],
                                 whole["jout"]["mask_logits"])
    assert sem.shape == VOL[:4] + (HEAD["num_classes"],)
    close(sem, want, 2e-3)


@pytest.mark.parametrize("levels", ["single", "pyramid"])
def test_head_weights_round_trip(whole, levels):
    """Every leaf of the JAX ``init`` tree maps to a port tensor of its
    shape (``flax_template`` equals the init tree's shapes), and a tree of
    distinct values goes in by ``load_flax_params`` and comes back
    bitwise by ``flax_trees``; on one volume and on a three-level pyramid
    of different widths (the FPN branch's weights)."""
    if levels == "single":
        chans = VOL[-1]
        args = (jnp.asarray(whole["x"]),)
    else:
        chans = [6, 8, 10]
        shapes = [(8, 8, 4), (4, 4, 2), (2, 2, 1)]
        args = ([jnp.zeros((1,) + s + (c,)) for s, c in zip(shapes, chans)],)
    jmod = jm.Mask2FormerOccHead(**HEAD)
    init = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"]
    port = tm.Mask2FormerOccHead(chans, device="cpu", **HEAD)
    want = {k: v.shape for k, v in _flatten(init).items()}
    assert {k: np.shape(v) for k, v in _flatten(flax_template(port)).items()} \
        == want
    tree = distinct_tree(init)
    load_flax_params(port, tree, None)
    back = _flatten(flax_trees(port)[0])
    assert back.keys() == tree.keys()
    for key, value in tree.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
