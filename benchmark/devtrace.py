"""The device trace of a traced run: ``torch.profiler`` over a few units
of work (steps or calls), reduced to kernel intervals, the device's busy
time, the idle gaps and what the host was doing in them.

The per-layer metric readers (``metrics/*.py``) take a ``Trace`` and the
run's counts; the name patterns that pick their kernels sit in each
reader's own file.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch


class Trace:
    """Kernels as (name, start_us, end_us) on the device, host operators
    as (name, start_us, end_us, thread), and the traced window's seconds,
    over ``units`` units of work."""

    def __init__(self, kernels, host_ops, window_s: float, units: int):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.host_ops = host_ops
        self.window_s = window_s
        self.units = units
        self.busy_intervals = _merge((s, e) for _, s, e in self.kernels)
        self.busy_s = sum(e - s for s, e in self.busy_intervals) / 1e6

    def seconds(self, patterns: Iterable[str]) -> float:
        """Device seconds in kernels whose name holds any of
        ``patterns``."""
        pats = tuple(patterns)
        return sum(e - s for n, s, e in self.kernels
                   if any(p in n for p in pats)) / 1e6

    def kernel_seconds(self) -> float:
        return sum(e - s for _, s, e in self.kernels) / 1e6

    def top_kernels(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            key = _short(name)
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device intervals, summed by the innermost
        host operator running at each gap's middle (on any thread; the
        latest started wins), 'host:_none' where none ran."""
        gaps = [(s0, e1) for (_, s0), (e1, _) in
                zip(self.busy_intervals[:-1], self.busy_intervals[1:])]
        ops = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in ops]
        by: Dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            best = None
            i = bisect.bisect_right(starts, mid)
            # walk back over operators that started before the middle;
            # the first that still runs there is the innermost one
            for j in range(i - 1, max(-1, i - 4000), -1):
                if ops[j][2] >= mid:
                    best = ops[j][0]
                    break
            key = _short(best) if best else 'host:_none'
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]


def _merge(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _short(name: str) -> str:
    return re.sub(r'[^A-Za-z0-9_.:\-]+', '_', name)[:64]


def record(work: Callable[[int], None], units: int, host: bool = False
           ) -> Trace:
    """Profile ``work(units)`` on the card, ending on a synchronize. With
    ``host`` the host's operators are recorded too, which slows the host
    and so widens the device's gaps: such a trace names what the host was
    doing in the gaps, and the device-only one gives the busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        work(units)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels, host_ops = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if getattr(e, 'is_user_annotation', False):
            continue
        tr = e.time_range
        if e.device_type == cuda:
            kernels.append((e.name, tr.start, tr.end))
        else:
            host_ops.append((e.name, tr.start, tr.end, e.thread))
    if not kernels:
        raise RuntimeError('the profiler recorded no device kernel')
    return Trace(kernels, host_ops, window_s, units)


def read_metrics(trace: Optional[Trace], run: dict, readers: dict
                 ) -> Dict[str, dict]:
    """Each reader's value with its unit; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    for name, (reader, unit) in readers.items():
        value = reader(trace, run)
        if value is not None:
            out[name] = {'value': value, 'unit': unit}
    return out
