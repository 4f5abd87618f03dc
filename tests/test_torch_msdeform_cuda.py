"""The 3D deformable attention's CUDA kernel (``csrc/msdeform.cu``)
against its plain route (``ops.msdeform_attn._msdeform``, the gathers of
``_sample_level``).

Needs an NVIDIA GPU and nvcc: every test here is marked ``cuda`` and skips
elsewhere. This file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_msdeform_cuda.py

Tolerances: fp32 1e-5 (both sum in fp32, in another order; TF32 off for
the plain route's product and, in the detector, cuDNN's convolutions). bf16: the kernel sums in fp32 and rounds once,
where the plain route rounds its folded weights to bf16 and adds the levels
in bf16, so against a float32 run of the plain route on the same bf16
inputs the kernel's widest gap is at most the plain route's own, plus fp32
rounding of the sum (1e-5 of the output's scale).
"""

import pytest
import torch

from stereoscene_torch import _build
from stereoscene_torch.models import mask2former_occ
from stereoscene_torch.models.detector import BEVDepthOccupancy
from stereoscene_torch.ops import msdeform_attn as ms
from stereoscene_torch.tools import _frames
from stereoscene_torch.utils.weights import seeded_init_
from test_torch_m2f_detector import LABEL_SHAPE, tiny_m2f_config

pytestmark = pytest.mark.cuda

CELL = ((64, 64, 8), (32, 32, 4), (16, 16, 2))  # the m2f cell's levels
# (name, batch, levels, heads, points, channels a head, queries: None for
# one a value row, as the pixel decoder asks)
CASES = [
    ("cell", 1, CELL, 8, 4, 24, None),
    ("batch 2, one level", 2, ((9, 7, 5),), 4, 3, 24, 300),
    ("ch 16", 1, ((8, 8, 4), (4, 4, 2)), 8, 4, 16, None),
    ("ch 12", 2, ((8, 8, 4), (4, 4, 2)), 2, 4, 12, 257),
    ("ch 3, four levels", 1, ((6, 6, 4), (3, 3, 2), (2, 2, 1), (1, 1, 1)),
     4, 2, 3, None),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc)")
    _build.load_kernels()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32


def inputs(dev, b, shapes, heads, points, ch, q, seed=0, loc=None):
    """Seeded value [B, N, heads * ch], locations in [-0.2, 1.2] (or
    ``loc``) and softmaxed weights, all fp32."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = sum(x * y * z for x, y, z in shapes)
    q = n if q is None else q
    value = torch.randn(b, n, heads * ch, generator=gen, device=dev)
    if loc is None:
        loc = torch.rand(b, q, heads, len(shapes), points, 3, generator=gen,
                         device=dev) * 1.4 - 0.2
    attn = torch.softmax(torch.randn(b, q, heads, len(shapes) * points,
                                     generator=gen, device=dev), -1)
    return value, loc, attn.reshape(b, q, heads, len(shapes), points)


def kernel_and_plain(value, shapes, loc, attn, heads):
    before = _build.launch_counts["msdeform_attn_3d"]
    got = ms.msdeform_attn_3d(value, shapes, loc, attn, heads)
    assert _build.launch_counts["msdeform_attn_3d"] == before + 1
    want = ms.msdeform_attn_3d(value, shapes, loc, attn, heads,
                               use_kernel=False)
    assert _build.launch_counts["msdeform_attn_3d"] == before + 1
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fp32_kernel_matches_plain(dev, case):
    _, b, shapes, heads, points, ch, q = case
    value, loc, attn = inputs(dev, b, shapes, heads, points, ch, q)
    got, want = kernel_and_plain(value, shapes, loc, attn, heads)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_kernel_within_the_plain_routes_gap(dev, case):
    _, b, shapes, heads, points, ch, q = case
    value, loc, attn = inputs(dev, b, shapes, heads, points, ch, q, seed=1)
    value, attn = value.bfloat16(), attn.bfloat16()
    got, plain = kernel_and_plain(value, shapes, loc, attn, heads)
    assert got.dtype == torch.bfloat16
    ref = ms.msdeform_attn_3d(value.float(), shapes, loc, attn.float(),
                              heads, use_kernel=False)
    kernel_gap = float((got.float() - ref).abs().max())
    plain_gap = float((plain.float() - ref).abs().max())
    assert kernel_gap <= plain_gap + 1e-5 * float(ref.abs().max()), \
        (kernel_gap, plain_gap)


def edge_locations(dev, b, q, heads, shapes, points, seed):
    """Locations drawn per axis from: below 0, a corner one cell outside
    (pixel -1), exactly on each cell's corner (pixel k), on a cell edge
    (pixel k + 0.5), the last corner (pixel n - 1), the far edge (pixel
    n - 0.5), one cell outside (pixel n) and above 1."""
    gen = torch.Generator().manual_seed(seed)
    loc = torch.empty(b, q, heads, len(shapes), points, 3)
    for lvl, shape in enumerate(shapes):
        for axis, n in enumerate(shape):
            picks = [-0.3, -0.5 / n, 1.0, 1.0 + 0.5 / n, 1.4]
            picks += [(k + 0.5) / n for k in range(n)]  # pixel k
            picks += [(k + 1.0) / n for k in range(n)]  # pixel k + 0.5
            choice = torch.randint(len(picks), (b, q, heads, points),
                                   generator=gen)
            loc[:, :, :, lvl, :, axis] = torch.tensor(picks)[choice]
    return loc.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_edges_and_corners(dev, dtype):
    shapes, heads, points, ch, q = ((6, 5, 3), (3, 2, 1)), 4, 4, 8, 500
    loc = edge_locations(dev, 1, q, heads, shapes, points, 2)
    value, loc, attn = inputs(dev, 1, shapes, heads, points, ch, q, seed=3,
                              loc=loc)
    value, attn = value.to(dtype), attn.to(dtype)
    got, want = kernel_and_plain(value, shapes, loc, attn, heads)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        ref = ms.msdeform_attn_3d(value.float(), shapes, loc, attn.float(),
                                  heads, use_kernel=False)
        assert float((got.float() - ref).abs().max()) <= \
            float((want.float() - ref).abs().max()) + 1e-5 * float(
                ref.abs().max())
    # every location outside every level: zeros, as the plain route gives
    far = torch.full_like(loc, 1.6)
    got, want = kernel_and_plain(value, shapes, far, attn, heads)
    assert torch.equal(got, want) and not bool(got.any())


def test_m2f_infer_takes_the_kernel_and_keeps_the_class_map(dev):
    """``infer`` launches the kernel once an encoder layer, and with
    ``use_kernel=False`` none; the class scores agree to 1e-4 of their
    scale and the whole class maps are equal. A seeded model's class
    boundaries hold voxels whose two best scores differ by under 1e-6, where
    fp32 sums in another order pick either class (the trunk's kernels alone
    do), so the model is seeded where every voxel's two best scores lie
    more than twice that 1e-4 apart (2.2e-3 of the scale on the CPU; two
    classes)."""
    torch.manual_seed(0)
    cfg = tiny_m2f_config()
    model = BEVDepthOccupancy(cfg, device=dev, label_shape=LABEL_SHAPE)
    seeded_init_(model, 161)
    batch = _frames.frame(cfg, dev, seed=5)
    layers = cfg.mask_head["num_encoder_layers"]
    before = _build.launch_counts["msdeform_attn_3d"]
    got = model.infer(batch)
    assert _build.launch_counts["msdeform_attn_3d"] == before + layers
    want = model.infer(batch, use_kernel=False)
    assert _build.launch_counts["msdeform_attn_3d"] == before + layers
    got_scores = model.class_scores(model(batch), LABEL_SHAPE)
    scores = model.class_scores(model(batch, use_kernel=False), LABEL_SHAPE)
    tol = 1e-4 * float(scores.abs().max())
    assert float((got_scores - scores).abs().max()) <= tol
    top2 = scores.topk(2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 2 * tol
    assert want.unique().numel() == 2
    assert torch.equal(got, want)


def test_head_under_grad_needs_use_kernel_false(dev):
    """The kernel is forward-only: a training forward of the head on CUDA
    raises unless it passes ``use_kernel=False``, which takes the plain
    gathers and their backward; under no-grad the head launches the kernel
    once an encoder layer."""
    torch.manual_seed(0)
    head = mask2former_occ.Mask2FormerOccHead(
        16, num_queries=4, embed_dim=16, num_layers=1, num_classes=3,
        num_heads=2, num_encoder_layers=2, device=dev).train()
    x = torch.randn(1, 8, 8, 4, 16, device=dev)
    before = _build.launch_counts["msdeform_attn_3d"]
    with pytest.raises(NotImplementedError, match="forward-only"):
        head(x)
    out = head(x, use_kernel=False)
    out["mask_logits"].float().square().mean().backward()
    assert _build.launch_counts["msdeform_attn_3d"] == before
    assert head.pixel_decoder.encoder0.value_proj.weight.grad is not None
    with torch.no_grad():
        head.eval()(x)
    assert _build.launch_counts["msdeform_attn_3d"] == before + 2
