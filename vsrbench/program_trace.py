"""The program's own spans and counters, as the per-layer readers use them.

The program (``tecogan_tpu_torch.utils.tracing``) keeps each span it
records while a profiler records, with its start and end on the host's
wall clock (the clock kineto's device events carry) and, on a card, the
device time between two CUDA events it recorded on its stream at the span's
start and end; and counters since the process started. A reader calls
these functions after the traced sub-window has closed. Each returns None
where the program has no such span or counter (a program that predates
them), and the readers then report nothing.
"""

from __future__ import annotations

from .trace import _union


def _tracing():
    try:
        from tecogan_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def spans_in(trace, name: str):
    """The program's spans named ``name`` (without ``tecogan.``) that fall
    in the traced sub-window ``trace`` (a ``vsrbench.trace.Trace``), or
    None where the program keeps no spans. The window is placed by its
    device operations: it holds all of them and lasts ``window_s``."""
    tracing = _tracing()
    if tracing is None or not trace.kernels:
        return None
    width = int(trace.window_s * 1e9)
    lo = max(e for _, _, e in trace.kernels) - width
    hi = min(s for _, s, _ in trace.kernels) + width
    return [s for s in tracing.spans()
            if s.name == name and s.end_ns >= lo and s.start_ns <= hi]


def counters():
    """The program's counters since the process started, or None."""
    tracing = _tracing()
    return None if tracing is None else tracing.counters()


def idle_inside_s(trace, intervals) -> float:
    """Seconds with no device operation running inside the (start_ns,
    end_ns) ``intervals`` (each taken alone), from ``trace``'s device
    operations."""
    merged = _union([(s, e) for _, s, e in trace.kernels])
    idle = 0
    for a, b in intervals:
        busy = sum(max(0, min(e, b) - max(s, a)) for s, e in merged)
        idle += (b - a) - busy
    return idle / 1e9
