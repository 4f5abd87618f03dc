"""``images_replays.serve`` on hand-made traces: one replay range a frame
reads 1.0, a frame without one lowers the share, a range outside the
window is not counted, and no replay range, no trace or no frames read
None."""

import pytest

from ssc_bench.cell import Cell

from .test_ssc_bench_arith import fake_trace

READ = Cell("x", 1, {}, {}, [], [], {}).reader("images_replays.serve")


def frames(n, replayed, window=None):
    """``n`` frames of 1,000 ns, each an images range [100, 400); those in
    ``replayed`` hold a replay range [120, 380) in it."""
    ranges = []
    for f in range(n):
        t = 1000 * f
        ranges += [("stereoscene.infer", t, t + 1000),
                   ("stereoscene.images", t + 100, t + 400)]
        if f in replayed:
            ranges.append(("stereoscene.images.replay", t + 120, t + 380))
    return fake_trace([("conv", 150, 350, 130)], ranges,
                      window=window or (0, 1000 * n))


@pytest.mark.parametrize("n,replayed,window,want", [
    (3, {0, 1, 2}, None, 1.0),
    (4, {0, 2, 3}, None, 0.75),
    # the first frame's replay lies before the window opens
    (3, {0, 1, 2}, (500, 3000), 1.0 * 2 / 3),
    (3, set(), None, None)])
def test_replays_a_frame(n, replayed, window, want):
    got = READ({"trace": frames(n, replayed, window), "frames": n})
    assert got == (None if want is None else pytest.approx(want))


def test_none_without_a_trace_or_frames():
    assert READ({"trace": None, "frames": 3}) is None
    assert READ({"trace": frames(3, {0, 1, 2}), "frames": 0}) is None
    assert READ({"frames": 3}) is None
