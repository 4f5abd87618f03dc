"""The image backbone's CUDA graph (``models/efficientnet.py``,
``CustomEfficientNet.forward``).

On the CPU, a stand-in capture backend (``StandInGraphs``, put in place of
``efficientnet.GRAPHS``) records each capture and replay and runs the body
eagerly, so the graph cache's control flow runs here: the first call with
an input key is eager, the second captures and replays, the third
replays; training, autograd, a capturing stream and the real backend on
CPU tensors never capture; a new shape or strides replace the graph;
``.to(dtype)`` drops it; every output equals eager mode's.

On the card (marked ``cuda``, skipped elsewhere), EfficientNet-b7 at a
small input: the replay equals eager mode bitwise, after
``load_state_dict`` of other weights it gives their eager result, and
after ``.to(torch.bfloat16)`` it captures anew. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_backbone_graph.py
"""

import pytest
import torch

from stereoscene_torch.models import efficientnet
from stereoscene_torch.models.efficientnet import CustomEfficientNet
from stereoscene_torch.utils.weights import seeded_init_

OUT = (2, 3, 4, 5, 6)  # the detector's stages


class StandInGraphs:
    """A capture backend for the CPU: ``capture`` runs the body once and
    keeps it; each ``replay`` runs it again into the captured outputs.
    ``calls`` records "capture" and "replay" in order; while ``capturing``
    it accepts no input, as a capturing CUDA stream."""

    def __init__(self):
        self.calls = []
        self.capturing = False

    def accepts(self, x):
        return not self.capturing

    def capture(self, body):
        self.calls.append("capture")
        self.capturing = True
        try:
            out = body()
        finally:
            self.capturing = False
        return _StandInGraph(self, body, out), out


class _StandInGraph:
    def __init__(self, backend, body, out):
        self.backend, self.body, self.out = backend, body, out

    def replay(self):
        self.backend.calls.append("replay")
        for static, fresh in zip(self.out, self.body()):
            static.copy_(fresh)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on the
    CPU at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def stand_in(monkeypatch):
    backend = StandInGraphs()
    monkeypatch.setattr(efficientnet, "GRAPHS", backend)
    return backend


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = CustomEfficientNet("b0", OUT)
    seeded_init_(m, 0)
    return m.eval()


@pytest.fixture(autouse=True)
def fresh(model):
    model.eval()
    model.float()  # drops any graph an earlier test left
    yield


def images(seed, shape=(2, 3, 64, 96), dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def eager(model, x):
    """The body's outputs in eager mode (under autograd), in the model's
    mode."""
    with torch.enable_grad():
        return [o.detach() for o in model(x)]


def served(model, x):
    with torch.no_grad():
        return model(x)


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_eager_then_capture_then_replay(model, stand_in):
    xs = [images(i) for i in range(4)]
    first = served(model, xs[0])
    assert stand_in.calls == []
    assert_same(first, eager(model, xs[0]))
    second = served(model, xs[1])
    assert stand_in.calls == ["capture", "replay"]
    assert_same(second, eager(model, xs[1]))
    third = served(model, xs[2])
    assert stand_in.calls == ["capture", "replay", "replay"]
    # the graph's static outputs, overwritten by the replay
    assert all(a is b for a, b in zip(second, third))
    assert_same(third, eager(model, xs[2]))
    assert_same(served(model, xs[3]), eager(model, xs[3]))
    assert stand_in.calls == ["capture"] + ["replay"] * 3


@pytest.mark.parametrize("case", ["training", "grad", "capturing", "cpu"])
def test_never_captures(model, stand_in, monkeypatch, case):
    made = []
    if case == "cpu":  # the real backend on CPU tensors
        monkeypatch.setattr(efficientnet, "GRAPHS", efficientnet.CudaGraphs)
        monkeypatch.setattr(torch.cuda, "CUDAGraph",
                            lambda *a, **k: made.append(a))
    stand_in.capturing = case == "capturing"
    if case == "training":
        model.train()
    grad = torch.enable_grad() if case == "grad" else torch.no_grad()
    for seed in range(3):
        x = images(seed)
        with grad:
            got = [o.detach() for o in model(x)]
        assert_same(got, eager(model, x))  # training: batch statistics
    assert stand_in.calls == [] and made == []
    assert model._graph is None


def test_new_input_key_replaces_the_graph(model, stand_in):
    small, large = images(0), images(1, (2, 3, 96, 64))
    permuted = images(2, (2, 64, 96, 3)).permute(0, 3, 1, 2)  # small's shape
    for x in (small, small):
        served(model, x)
    assert stand_in.calls == ["capture", "replay"]
    graph = model._graph
    assert_same(served(model, large), eager(model, large))  # eager
    assert model._graph is None and stand_in.calls == ["capture", "replay"]
    assert_same(served(model, large), eager(model, large))  # captures
    assert model._graph is not None and model._graph is not graph
    assert stand_in.calls == ["capture", "replay"] * 2
    # the same shape in other strides is another key
    for x in (small, small):
        served(model, x)
    assert model._graph[1].stride() == small.stride()
    assert_same(served(model, permuted), eager(model, permuted))
    assert model._graph is None
    assert_same(served(model, permuted), eager(model, permuted))
    assert model._graph[1].stride() == permuted.stride()
    assert stand_in.calls == ["capture", "replay"] * 4


def test_to_dtype_drops_the_graph(model, stand_in):
    for seed in range(2):
        served(model, images(seed))
    assert model._graph is not None
    model.to(torch.float64)
    assert model._graph is None and model._graph_key is None
    x = images(5, dtype=torch.float64)
    for n in (0, 1, 1):
        assert_same(served(model, x), eager(model, x))
        assert stand_in.calls.count("capture") == 1 + n
    assert model._graph[2][0].dtype == torch.float64


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    return torch.device("cuda", 0)


def _b7(dev, seed):
    torch.manual_seed(seed)
    m = CustomEfficientNet("b7", OUT)
    seeded_init_(m, seed)
    return m.to(dev).eval()


@pytest.mark.cuda
def test_b7_replay_on_the_card(dev):
    model, other = _b7(dev, 0), _b7(dev, 1)
    # the detector's input: channels-last images viewed as NCHW
    xs = [images(i, (2, 64, 96, 3)).to(dev).permute(0, 3, 1, 2)
          for i in range(4)]
    outs = [served(model, x) for x in xs[:3]]
    graph = model._graph
    assert graph is not None
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(outs[1], outs[2]))
    assert_same(outs[2], eager(model, xs[2]))
    assert all(torch.isfinite(o).all() for o in outs[2])
    # the replay reads the weights that load_state_dict copies in place
    model.load_state_dict(other.state_dict())
    assert_same(served(model, xs[3]), eager(other, xs[3]))
    assert model._graph is graph
    # a new dtype: eager, then a new capture, then replays
    model.to(torch.bfloat16)
    assert model._graph is None
    bf = [x.to(torch.bfloat16) for x in xs]
    got = [served(model, x) for x in bf]
    assert model._graph is not None and model._graph is not graph
    assert_same(got[0], eager(model, bf[0]))
    assert_same(got[3], eager(model, bf[3]))
    assert got[3][0].dtype == torch.bfloat16
