"""The device trace of a traced run: ``torch.profiler`` over the measured
window, read from its Kineto events in memory (no trace file).

- ``window``: the harness's ``ssc.window`` range on the host;
- ``kernels``: every device operation (kernel, copy, fill) in the window,
  with its launch time on the host where the trace links it;
- ``busy_s``: the union of the device operations' intervals;
- ``idle``: the gaps of that union, each labelled by the innermost of the
  harness's ``ssc.*`` ranges open on the host at the gap's midpoint.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "ssc.window"


@dataclasses.dataclass
class Op:
    name: str
    start: int  # ns, the host clock's time base
    end: int
    launch: Optional[int]  # ns of its launch on the host, if linked


class Trace:
    """``with Trace() as t:`` profiles the block; afterwards ``t.ops``,
    ``t.ranges`` and the window are read."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self.ops: List[Op] = []
        self.ranges: List[Tuple[str, int, int]] = []
        self.window: Tuple[int, int] = (0, 0)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())
        return False

    def _read(self, events) -> None:
        host_by_corr: Dict[int, int] = {}
        device = []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append(e)
                continue
            if e.is_user_annotation():
                self.ranges.append((e.name(), e.start_ns(), e.end_ns()))
            # runtime calls (cudaLaunchKernel, cudaMemcpyAsync, ...) carry
            # the correlation id of the device operation they start
            if e.correlation_id():
                host_by_corr.setdefault(e.correlation_id(), e.start_ns())
        windows = [(s, t) for n, s, t in self.ranges if n == WINDOW]
        if not windows:
            raise RuntimeError("trace: no ssc.window range recorded")
        self.window = windows[-1]
        ws, we = self.window
        for e in device:
            start, end = e.start_ns(), e.end_ns()
            if end <= ws or start >= we:
                continue
            launch = host_by_corr.get(e.correlation_id())
            if launch is None:
                launch = host_by_corr.get(e.linked_correlation_id())
            self.ops.append(Op(e.name(), start, end, launch))
        self.ops.sort(key=lambda op: op.start)

    # ------------------------------------------------------------ reads

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        ws, we = self.window
        merged: List[List[int]] = []
        for op in self.ops:
            s, e = max(op.start, ws), min(op.end, we)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, match: str) -> Tuple[float, int]:
        """(device seconds, launches) of the operations whose name holds
        ``match``."""
        ops = [op for op in self.ops if match in op.name]
        return sum(op.end - op.start for op in ops) / 1e9, len(ops)

    def seconds_under(self, range_name: str) -> float:
        """Device seconds of the operations launched inside a host range
        of this name."""
        spans = sorted((s, e) for n, s, e in self.ranges if n == range_name)
        starts = [s for s, _ in spans]
        total = 0
        for op in self.ops:
            if op.launch is None:
                continue
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                total += op.end - op.start
        return total / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        by = collections.Counter()
        for op in self.ops:
            by[op.name[:160]] += (op.end - op.start) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle device seconds in the window by the harness range open on
        the host at each gap's midpoint (``host`` outside every range; the
        harness's ranges other than the window do not nest)."""
        ws, we = self.window
        ours = sorted((s, e, name) for name, s, e in self.ranges
                      if name.startswith("ssc.") and name != WINDOW)
        starts = [r[0] for r in ours]
        edges = [ws] + [t for iv in self.busy_intervals() for t in iv] + [we]
        by = collections.Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = ours[i][2] if i >= 0 and mid <= ours[i][1] else "host"
            by[label] += (b - a) / 1e9
        return [[k, v] for k, v in by.most_common(n)]
