"""The port's spans and counters.

Spans. ``span(name, args)`` marks a phase of the program (a training step
and its parts, a streaming chunk and its parts) as the profiler range
``tecogan.<name>``, while a profiler records: any ``torch.profiler``
around the port's calls, profile mode's ``TECOGAN_TRACE_DIR``. With no
profiler recording it returns one shared no-op context, so the path pays
one check a span. There is no setting: spans are on exactly while a
profiler records.

The range is an operator-scope record function (the one
``torch._C._profiler._RecordFunctionFast`` enters), not the user scope of
``torch.profiler.record_function``: kineto copies a user-scope range onto
the device timeline as one interval from the first kernel launched inside
it to the last, and such a copy of a training step would count the step's
idle gaps as device work in any reading of the trace.

While a profiler records, each span is also kept in memory (``spans()``,
the newest ``SPAN_LOG`` of them): its name and args, its start and end on
the host's wall clock (``time.time_ns``, the clock kineto's events carry),
and on a card two CUDA events that it records on the current
stream at its start and end, so that the device time between them can be
read once the work is done (``SpanRecord.device_ms``).

Counters. ``counters()`` is a snapshot of the program's counters since the
process started; each counter has one writing thread (``add``). The warp
kernels' launch counts stay with their wrappers (``ops.kernel_launches``).

- ``loader.assembled``, ``loader.assemble_s``: batches the loader's
  producer thread built, and its seconds inside them;
- ``loader.epoch_starts``, ``loader.epoch_start_wait_s``: epochs whose
  first batch the consumer received, and its seconds waiting for each
  epoch's first batch (the loader's restart);
- ``networks.nhwc_forwards``, ``networks.nchw_forwards``: FNet and SRNet
  forwards (the launching thread's) that ran channels_last (bf16) and
  NCHW (any other dtype), one a forward (``nn.network_layout``).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

__all__ = ["span", "spans", "SpanRecord", "counters", "add", "SPAN_LOG"]

SPAN_LOG = 16384  # spans kept in memory, the newest

_NULL = contextlib.nullcontext()
_LOG: collections.deque = collections.deque(maxlen=SPAN_LOG)
_COUNTERS = {"loader.assembled": 0, "loader.assemble_s": 0.0,
             "loader.epoch_starts": 0, "loader.epoch_start_wait_s": 0.0,
             "networks.nhwc_forwards": 0, "networks.nchw_forwards": 0}


class SpanRecord(NamedTuple):
    """One span as it was recorded: ``start_ns``/``end_ns`` on the host's
    wall clock, ``marks`` its (start, end) CUDA events, None off a card."""
    name: str
    args: dict | None
    start_ns: int
    end_ns: int
    marks: tuple | None

    def device_ms(self) -> float | None:
        """Milliseconds of the span's stream between its two marks: the
        device time of the work launched on that stream inside the span,
        with any device idle between it (None off a card). Waits for the
        end mark."""
        if self.marks is None:
            return None
        self.marks[1].synchronize()
        return self.marks[0].elapsed_time(self.marks[1])


class _Span:
    __slots__ = ("name", "args", "rf", "start", "mark")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        full = "tecogan." + self.name
        self.rf = (torch._C._profiler._RecordFunctionFast(full)
                   if self.args is None else
                   torch._C._profiler._RecordFunctionFast(full, [],
                                                          self.args))
        self.rf.__enter__()
        self.start = time.time_ns()
        self.mark = _mark()
        return self

    def __exit__(self, *exc):
        mark = _mark()
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _LOG.append(SpanRecord(self.name, self.args, self.start, end,
                               None if mark is None else (self.mark, mark)))
        return False


def _mark():
    """A CUDA event recorded on the current stream, None where CUDA is not
    in use in this process."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def span(name: str, args: dict | None = None):
    """The range ``tecogan.<name>`` (``args``: int values shown with it)
    while a profiler records; otherwise a shared no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _NULL
    return _Span(name, args)


def spans() -> list:
    """The spans kept in memory, oldest first (``SpanRecord``s)."""
    return list(_LOG)


def add(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` (one of ``counters()``'s keys;
    each counter is written by one thread)."""
    _COUNTERS[name] += value


def counters() -> dict:
    """A snapshot of the program's counters (the module docstring lists
    them)."""
    return dict(_COUNTERS)
