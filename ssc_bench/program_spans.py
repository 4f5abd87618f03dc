"""What the readers of the program's own spans share.

The program opens ``stereoscene.*`` ranges at its stage and step
boundaries (``stereoscene_torch/utils/spans.py``) while a profiler is
active, so a traced run's ``Trace.ranges`` holds them beside the
harness's ``ssc.*`` ranges. Attribution is by timestamps alone:

- a device idle gap of the window belongs to a span name when the gap's
  midpoint lies inside a range of that name;
- a device operation belongs to a span name when its launch on the host
  lies inside such a range, whichever thread launched it (autograd's
  device thread launches the backward's operations while
  ``stereoscene.backward`` is open on the calling thread).

A range holds [start, end), so two siblings that meet never share a gap
or an operation. The ranges of the names read together are merged first,
so nested or overlapping ranges count once. Each read is divided by the
run's ``frames`` or ``steps``, and is None where the trace, the count or
the spans are absent (a program that opens none).
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple


def intervals(trace, names: Iterable[str]) -> List[Tuple[int, int]]:
    """The union of the ranges whose name is in ``names``, as sorted,
    disjoint (start, end) pairs in ns."""
    names = set(names)
    merged: List[List[int]] = []
    for s, e in sorted((s, e) for n, s, e in trace.ranges if n in names):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _inside(spans: List[Tuple[int, int]], starts: List[int], t: int) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < spans[i][1]


def idle_ns(trace, names: Iterable[str]) -> int:
    """Device idle ns of the window in gaps whose midpoint lies inside a
    range of ``names``."""
    spans = intervals(trace, names)
    starts = [s for s, _ in spans]
    ws, we = trace.window
    edges = [ws] + [t for iv in trace.busy_intervals() for t in iv] + [we]
    return sum(b - a for a, b in zip(edges[0::2], edges[1::2])
               if b > a and _inside(spans, starts, (a + b) // 2))


def launched(trace, names: Iterable[str]) -> list:
    """The device operations launched inside a range of ``names``."""
    spans = intervals(trace, names)
    starts = [s for s, _ in spans]
    return [op for op in trace.ops
            if op.launch is not None and _inside(spans, starts, op.launch)]


def _per(ctx, per: str, names) -> Optional[Tuple[object, int]]:
    """(trace, count) where the trace holds a range of ``names`` and the
    run counted some ``per`` (``frames`` or ``steps``), else None."""
    trace, count = ctx.get("trace"), ctx.get(per)
    if trace is None or not count:
        return None
    if not any(n in names for n, _, _ in trace.ranges):
        return None
    return trace, count


def idle_ms(ctx, names: Tuple[str, ...], per: str) -> Optional[float]:
    """Device idle ms a frame or step while a range of ``names`` is
    open."""
    found = _per(ctx, per, names)
    if found is None:
        return None
    trace, count = found
    return idle_ns(trace, names) / 1e6 / count


def device_ms(ctx, names: Tuple[str, ...], per: str) -> Optional[float]:
    """Device ms a frame or step of the operations launched inside a range
    of ``names``."""
    found = _per(ctx, per, names)
    if found is None:
        return None
    trace, count = found
    return sum(op.end - op.start
               for op in launched(trace, names)) / 1e6 / count


def launches(ctx, names: Tuple[str, ...], per: str) -> Optional[float]:
    """Device operations (kernels, copies, fills) a frame or step launched
    inside a range of ``names``."""
    found = _per(ctx, per, names)
    if found is None:
        return None
    trace, count = found
    return len(launched(trace, names)) / count
