"""The 3D deformable attention's routing on the CPU
(``stereoscene_torch.ops.msdeform_attn``); the kernel itself is held
against the plain route on the card in tests/test_torch_msdeform_cuda.py.

- CPU tensors take the plain gathers: no launch is counted and no
  ``stereoscene.msdeform.kernel`` range opens, and ``use_kernel=True``
  raises;
- the kernel's wrapper refuses what the kernel does not take before any
  launch;
- the host-side level table (sizes, strides, first rows) is
  ``_geometry_3d``'s and the flattened rows ``_msdeform`` walks;
- the Mask2Former head passes ``use_kernel`` down as it is given, under
  grad mode too (``_dispatch.want_kernel`` refuses the forward-only kernel
  there on CUDA), and the detector passes ``infer``'s ``use_kernel`` to it;
- the benchmark's ``msdeform_kernels.serve`` reads the kernel ranges a
  call on hand-made traces (0.0 where the calls fell back to the plain
  gathers), and None without calls or on a program that declares no
  kernel span.
"""

import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssc_bench.cell import Cell
from ssc_bench.trace import Op, Trace
from stereoscene_torch import _build
from stereoscene_torch.models import mask2former_occ
from stereoscene_torch.models.detector import BEVDepthOccupancy
from stereoscene_torch.ops import msdeform_attn as ms
from stereoscene_torch.tools import _frames
from stereoscene_torch.utils.weights import seeded_init_
from tests.test_torch_m2f_detector import LABEL_SHAPE, tiny_m2f_config

SHAPES = ((4, 4, 2), (2, 2, 1))
READ = Cell("x", 1, {}, {}, [], [], {}).reader("msdeform_kernels.serve")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(shapes=SHAPES, b=2, q=5, heads=2, ch=3, points=2,
           dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    n = sum(x * y * z for x, y, z in shapes)
    value = torch.randn(b, n, heads * ch, generator=gen).to(dtype)
    loc = torch.rand(b, q, heads, len(shapes), points, 3,
                     generator=gen) * 1.4 - 0.2
    attn = torch.softmax(torch.randn(b, q, heads, len(shapes) * points,
                                     generator=gen), -1).to(dtype)
    return value, loc, attn.reshape(b, q, heads, len(shapes), points)


def opened(prof):
    return [e.name for e in prof.events()
            if e.name.startswith("stereoscene.msdeform")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_route(dtype):
    value, loc, attn = inputs(dtype=dtype)
    before = dict(_build.launch_counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = ms.msdeform_attn_3d(value, SHAPES, loc, attn, 2)
    assert opened(prof) == ["stereoscene.msdeform"]
    assert dict(_build.launch_counts) == before
    want = ms._msdeform(value, SHAPES, loc, attn, 2, ms._geometry_3d)
    assert torch.equal(got, want)
    assert torch.equal(ms.msdeform_attn_3d(value, SHAPES, loc, attn, 2,
                                           use_kernel=False), want)


def test_cpu_refuses_the_kernel():
    value, loc, attn = inputs()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ms.msdeform_attn_3d(value, SHAPES, loc, attn, 2, use_kernel=True)
    assert _build.launch_counts["msdeform_attn_3d"] == 0


@pytest.mark.parametrize("case,error", [
    ("half values", TypeError),
    ("fp64 locations", TypeError),
    ("five levels", ValueError),
    ("rows", ValueError),
    ("heads", ValueError),
    ("cpu", ValueError)])
def test_kernel_wrapper_refuses_before_launching(case, error):
    value, loc, attn = inputs()
    shapes = SHAPES
    if case == "half values":
        value, attn = value.half(), attn.half()
    elif case == "fp64 locations":
        loc = loc.double()
    elif case == "five levels":
        shapes = ((1, 1, 1),) * 5
        value, loc, attn = inputs(shapes)
    elif case == "rows":
        value = value[:, 1:]
    heads = 3 if case == "heads" else 2
    with pytest.raises(error):
        ms.msdeform_attn_3d_kernel(value, shapes, loc, attn, heads)
    assert _build.launch_counts["msdeform_attn_3d"] == 0


@pytest.mark.parametrize("shapes", [
    ((64, 64, 8), (32, 32, 4), (16, 16, 2)),  # the m2f cell's levels
    ((4, 3, 2),),
    ((5, 1, 3), (2, 2, 2), (1, 1, 1), (3, 4, 5))])
def test_level_table_is_the_plain_routes_geometry(shapes):
    table, rows = ms.level_table(shapes)
    assert len(table) == 4 * ms.KERNEL_LEVELS
    assert table[4 * len(shapes):] == (0,) * (4 * (ms.KERNEL_LEVELS
                                                   - len(shapes)))
    start = 0
    for lvl, shape in enumerate(shapes):
        x, y, z, first = table[4 * lvl:4 * lvl + 4]
        sizes, strides = ms._geometry_3d(shape)
        assert (x, y, z) == sizes
        assert (y * z, z, 1) == strides
        assert first == start
        start += x * y * z
    assert rows == start
    # a value that is its own row: a sample at the centre of one cell of one
    # level, with that level's weight 1, reads the row the table gives
    cells = [(lvl, c) for lvl, s in enumerate(shapes)
             for c in itertools.islice(itertools.product(*map(range, s)),
                                       0, None, 7)]
    value = torch.arange(rows, dtype=torch.float64)[None, :, None]
    loc = torch.full((1, len(cells), 1, len(shapes), 1, 3), 0.5)
    attn = torch.zeros(1, len(cells), 1, len(shapes), 1, dtype=torch.float64)
    want = []
    for i, (lvl, cell) in enumerate(cells):
        x, y, z, first = table[4 * lvl:4 * lvl + 4]
        loc[0, i, 0, lvl, 0] = torch.tensor(
            [(c + 0.5) / n for c, n in zip(cell, (x, y, z))])
        attn[0, i, 0, lvl, 0] = 1.0
        want.append(first + (cell[0] * y + cell[1]) * z + cell[2])
    got = ms._msdeform(value, shapes, loc, attn, 1, ms._geometry_3d)
    # rows are whole numbers: the fp32 locations leave a sliver on a
    # neighbouring cell
    assert got.flatten().tolist() == pytest.approx(want, abs=1e-2)


@pytest.mark.parametrize("levels", [0, ms.KERNEL_LEVELS + 1])
def test_level_table_refuses_what_the_kernel_cannot_hold(levels):
    with pytest.raises(ValueError, match="levels"):
        ms.level_table(((2, 2, 2),) * levels)


def recording(monkeypatch):
    """Record the ``use_kernel`` each deformable attention call of the head
    is given, and run the call."""
    seen = []
    plain = mask2former_occ.msdeform_attn_3d

    def record(*args):
        seen.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(mask2former_occ, "msdeform_attn_3d", record)
    return seen


@pytest.mark.parametrize("grad,use_kernel,want", [
    (False, None, None), (False, False, False), (True, None, None),
    (True, False, False)])
def test_head_routes_the_deformable_attention(monkeypatch, grad, use_kernel,
                                              want):
    seen = recording(monkeypatch)
    torch.manual_seed(0)
    head = mask2former_occ.Mask2FormerOccHead(
        8, num_queries=4, embed_dim=16, num_layers=1, num_classes=3,
        num_heads=2, num_encoder_layers=2, device="cpu").eval()
    x = torch.randn(1, 4, 4, 2, 8)
    with torch.set_grad_enabled(grad):
        head(x, use_kernel)
    assert seen == [want, want]


@pytest.mark.parametrize("use_kernel", [None, False])
def test_infer_passes_use_kernel_to_the_head(monkeypatch, use_kernel):
    seen = recording(monkeypatch)
    torch.manual_seed(0)
    cfg = tiny_m2f_config()
    model = BEVDepthOccupancy(cfg, device="cpu", label_shape=LABEL_SHAPE)
    seeded_init_(model, 3)
    model.infer(_frames.frame(cfg, "cpu", seed=5), use_kernel)
    assert seen == [use_kernel] * cfg.mask_head["num_encoder_layers"]


def trace(calls, kernels, window=(0, 1000 * 4)):
    """Four 1,000 ns frames, each with a deformable attention range
    [100, 300) a call of ``calls``, and a kernel range in it for those of
    ``kernels``."""
    ranges = []
    for f in range(4):
        t = 1000 * f
        ranges.append(("stereoscene.infer", t, t + 1000))
        for c in range(calls):
            s = t + 100 + 250 * c
            ranges.append(("stereoscene.msdeform", s, s + 200))
            if c in kernels:
                ranges.append(("stereoscene.msdeform.kernel", s + 20,
                               s + 180))
    t = Trace.__new__(Trace)
    t.ops = [Op("k", 150, 250, 130)]
    t.ranges = ranges + [("ssc.window", *window)]
    t.window = window
    return t


@pytest.mark.parametrize("calls,kernels,window,want", [
    (2, {0, 1}, None, 1.0),
    (3, {0, 1, 2}, None, 1.0),
    (2, {1}, None, 0.5),
    # the first frame lies before the window opens
    (2, {0, 1}, (1000, 4000), 1.0),
    (2, set(), None, 0.0),  # plain gathers: no kernel range
    (0, set(), None, None)])  # no deformable attention at all
def test_msdeform_kernels_reader(calls, kernels, window, want):
    got = READ({"trace": trace(calls, kernels, window or (0, 4000)),
                "frames": 4})
    assert got == (None if want is None else pytest.approx(want))


def test_msdeform_kernels_reader_without_a_trace():
    assert READ({"trace": None, "frames": 3}) is None
    assert READ({"frames": 3}) is None


def test_msdeform_kernels_reader_on_a_program_without_the_kernel_span(
        monkeypatch):
    """A program that declares no ``stereoscene.msdeform.kernel`` span (one
    without the kernel) reads None, not a fall-back to the gathers."""
    spans = tuple(s for s in READ.__globals__["SPANS"]
                  if s != "stereoscene.msdeform.kernel")
    monkeypatch.setitem(READ.__globals__, "SPANS", spans)
    assert READ({"trace": trace(2, set()), "frames": 4}) is None
    assert READ({"trace": trace(2, {0, 1}), "frames": 4}) is None
