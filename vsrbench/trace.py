"""The device trace of a steady sub-window: ``torch.profiler`` over a few
units of the cell's own work, reduced to the kernels' intervals, the busy
time (the union of device intervals), the idle gaps between them named by
what the host was doing, and the top device operations.

Host spans of the harness (``span``) are ``record_function`` ranges named
``vsrbench.<what>``; an idle gap is named by the innermost host range that
covers its midpoint.
"""

from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def span(rec: list | None, name: str):
    """A host span: its (name, start, end) in seconds appended to ``rec``
    (when given) and a profiler range ``vsrbench.<name>``."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"vsrbench.{name}"):
        yield
    if rec is not None:
        rec.append((name, t0, time.perf_counter()))


def _raw_events(prof):
    """(is_device, name, start_ns, end_ns) of every event of the profile,
    read from kineto's raw results (``prof.events()`` builds a tree of
    every event first, which takes seconds on a training step's trace)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.device_type() == cuda, e.name(), e.start_ns(),
             e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Trace:
    """A reduced profile: ``kernels`` [(name, start_ns, end_ns)],
    ``busy_s``, ``window_s``, ``units`` of work in it, and the breakdown
    (top device operations, longest idle gaps)."""

    def __init__(self, events, t0_ns: int, t1_ns: int, units: int):
        # device-side copies of the harness's host ranges are not work
        dev = [(n, s, e) for d, n, s, e in events
               if d and e > s and not n.startswith("vsrbench.")]
        host = [(n, s, e) for d, n, s, e in events if not d and e >= s]
        self.kernels = sorted(dev, key=lambda k: k[1])
        self.window_s = (t1_ns - t0_ns) / 1e9
        self.units = units
        merged = _union([(s, e) for _, s, e in self.kernels])
        self.busy_s = sum(e - s for s, e in merged) / 1e9
        by_name = {}
        for n, s, e in self.kernels:
            by_name[n] = by_name.get(n, 0) + (e - s)
        self.device_ops = sorted(([n, v / 1e9] for n, v in by_name.items()),
                                 key=lambda r: -r[1])
        gaps = [(merged[i][1], merged[i + 1][0])
                for i in range(len(merged) - 1)]
        if merged:
            gaps = [(t0_ns, merged[0][0])] + gaps + [(merged[-1][1], t1_ns)]
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:10]
        self.idle_gaps = [[self._host_at(host, (a + b) // 2), (b - a) / 1e9]
                          for a, b in gaps]

    @staticmethod
    def _host_at(host, t_ns: int) -> str:
        """The innermost host range around ``t_ns``, under the harness's
        own span when one covers it."""
        inner, mine = None, None
        for n, s, e in host:
            if s <= t_ns <= e:
                if n.startswith("vsrbench.") and (
                        mine is None or s >= mine[1]):
                    mine = (n, s)
                if inner is None or s >= inner[1]:
                    inner = (n, s)
        parts = [p[0] for p in (mine, inner) if p is not None]
        if len(parts) == 2 and parts[0] == parts[1]:
            parts = parts[:1]
        return " / ".join(parts) if parts else "host idle"

    def kernel_times(self, pattern: str) -> list:
        """Durations in seconds of the kernels whose name holds
        ``pattern``."""
        return [(e - s) / 1e9 for n, s, e in self.kernels if pattern in n]

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:10],
                "idle_gaps": self.idle_gaps}


def profile(work, units_of, device) -> Trace:
    """Run ``work()`` (a few steady units, ending in a sync) under the
    profiler on ``device``; ``units_of(result)`` gives the units it
    completed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with _profile(activities=acts) as prof:
        with torch.profiler.record_function("vsrbench.traced_window"):
            result = work()
            if cuda:
                torch.cuda.synchronize(device)
    events = _raw_events(prof)
    marks = [(s, e) for d, n, s, e in events
             if not d and n == "vsrbench.traced_window"]
    t0, t1 = marks[0] if marks else (min(s for _, _, s, _ in events),
                                     max(e for _, _, _, e in events))
    return Trace(events, t0, t1, units_of(result))
