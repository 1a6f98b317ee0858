"""The readers of the program's spans and counters on synthetic traces:
every reader the benchmark had before these reads the same with and
without the program's spans among the host events, each new reader gives
its number from synthetic spans, kernels and counters, and each reports
nothing where the program keeps no spans or counters."""

from __future__ import annotations

import collections
import json
import os

import pytest

from vsrbench import harness, program_trace
from vsrbench.trace import Trace

REPO = os.path.dirname(harness.HERE)
NEW = ("step_idle_ms.train", "vote_wait_ms.train",
       "epoch_start_wait_ms.train", "assemble_ms.train",
       "fnet_ms_per_frame.infer")
MS = 1_000_000  # ns


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _events(program: bool):
    """A traced window of 100 ms: the harness's ranges, kernels with idle
    gaps, an op inside the vote; with ``program``, the program's spans as
    host events (operator scope: no device-side copy)."""
    ev = [(False, "vsrbench.traced_window", 0, 100 * MS),
          (False, "vsrbench.step", 1 * MS, 90 * MS),
          (False, "aten::_local_scalar_dense", 41 * MS, 59 * MS),
          (True, "warp_dimage_dflow_kernel", 2 * MS, 10 * MS),
          (True, "warp_planes_kernel", 12 * MS, 20 * MS),
          (True, "sm90_xmma_fprop", 20 * MS, 40 * MS),
          (True, "sm90_xmma_fprop", 60 * MS, 80 * MS),
          (True, "vsrbench.step", 2 * MS, 80 * MS)]
    if program:
        ev += [(False, "tecogan.train.step", 1 * MS, 85 * MS),
               (False, "tecogan.train.d_forward", 21 * MS, 40 * MS),
               (False, "tecogan.train.vote", 40 * MS, 60 * MS),
               (False, "tecogan.infer.fnet", 1 * MS, 19 * MS)]
    return ev


def _rec(kind, program: bool):
    tr = Trace(_events(program), 0, 100 * MS, 8)
    if kind == "infer":
        return {"kind": "infer", "trace": tr, "dispatch_s": [0.3, 0.4],
                "calls": 2, "flops_per_frame": 1e12, "k1_bytes": 1e6,
                "launches": {}, "memory_peak_bytes": 1}
    return {"kind": "train", "trace": tr, "dispatch_s": [0.5],
            "batch_wait_s": [0.01, 0.03], "flops_in_trace": 1e14,
            "steps": 7, "k3k4_bytes": 1e6, "launches": {},
            "memory_peak_bytes": 1}


@pytest.mark.parametrize("kind", ["infer", "train"])
def test_the_accepted_readers_read_the_same_with_the_programs_spans(kind):
    old = [m for m in _bench()["per_layer"] if m["name"] not in NEW]
    assert len(old) == 10
    bare, spans = _rec(kind, False), _rec(kind, True)
    got = harness.read_metrics(old, spans)
    assert got == harness.read_metrics(old, bare)
    assert got  # each kind has readers that read this trace
    assert spans["trace"].device_ops == bare["trace"].device_ops
    assert spans["trace"].busy_s == bare["trace"].busy_s


class _Mark:
    """A CUDA event's stand-in: a device time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture
def program(monkeypatch):
    """The program's span log and counters, emptied for the test; returns
    a function that keeps one span."""
    from tecogan_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "_LOG", collections.deque())
    monkeypatch.setattr(tracing, "_COUNTERS",
                        dict.fromkeys(tracing.counters(), 0))

    def keep(name, start_ms, end_ms, device_ms=None):
        marks = None if device_ms is None else (_Mark(0.0),
                                                _Mark(device_ms))
        tracing._LOG.append(tracing.SpanRecord(
            name, None, int(start_ms * MS), int(end_ms * MS), marks))
    return tracing, keep


def _read(name, rec):
    return harness.reader(name)(rec)


def test_each_new_reader_reports_nothing_without_the_programs_record(
        program):
    for kind in ("infer", "train"):
        rec = _rec(kind, True)
        for name in NEW:
            assert _read(name, rec) is None, name


def test_step_idle_and_vote_wait_read_the_step_and_vote_spans(program):
    _, keep = program
    rec = _rec("train", True)
    # two steps: device idle inside [1, 45] is 1-2, 10-12, 40-45 (8 ms);
    # inside [50, 95] 50-60 and 80-95 (25 ms)
    keep("train.step", 1, 45)
    keep("train.vote", 40, 45)
    keep("train.step", 50, 95)
    keep("train.vote", 55, 60)
    keep("train.g_forward", 1, 30)
    assert _read("step_idle_ms.train", rec) == pytest.approx(16.5)
    assert _read("vote_wait_ms.train", rec) == pytest.approx(5.0)
    # spans outside the window (an earlier profiler's) are left out: the
    # window holds every device operation and lasts 100 ms
    keep("train.step", -500, -400)
    keep("train.vote", -450, -400)
    assert _read("step_idle_ms.train", rec) == pytest.approx(16.5)
    assert _read("vote_wait_ms.train", rec) == pytest.approx(5.0)
    assert _read("vote_wait_ms.train", _rec("infer", True)) is None


def test_the_loader_readers_divide_the_programs_counters(program):
    tracing, _ = program
    rec = _rec("train", True)
    assert _read("epoch_start_wait_ms.train", rec) is None
    assert _read("assemble_ms.train", rec) is None
    tracing.add("loader.epoch_starts", 4)
    tracing.add("loader.epoch_start_wait_s", 1.0)
    tracing.add("loader.assembled", 80)
    tracing.add("loader.assemble_s", 2.0)
    assert _read("epoch_start_wait_ms.train", rec) == pytest.approx(250.0)
    assert _read("assemble_ms.train", rec) == pytest.approx(25.0)
    # off a card: no device time in the traced sub-window
    cpu = dict(rec, trace=Trace([(False, "vsrbench.traced_window", 0,
                                  100 * MS)], 0, 100 * MS, 8))
    assert _read("assemble_ms.train", cpu) is None


def test_fnet_reads_the_device_time_between_each_fnet_spans_marks(program):
    _, keep = program
    rec = _rec("infer", True)
    keep("infer.chunk", 0, 50)
    keep("infer.fnet", 1, 19, device_ms=12.0)
    keep("infer.fnet", 51, 60, device_ms=4.0)
    keep("infer.recurrence", 19, 50, device_ms=30.0)
    assert _read("fnet_ms_per_frame.infer", rec) == pytest.approx(2.0)
    # a span without marks (recorded off a card) makes no reading
    keep("infer.fnet", 61, 62)
    assert _read("fnet_ms_per_frame.infer", rec) is None


def test_idle_inside_counts_each_interval_alone():
    tr = Trace(_events(False), 0, 100 * MS, 1)
    assert program_trace.idle_inside_s(tr, []) == 0
    assert program_trace.idle_inside_s(tr, [(0, 100 * MS)]) == \
        pytest.approx(0.044)
    assert program_trace.idle_inside_s(
        tr, [(0, 100 * MS), (40 * MS, 60 * MS)]) == pytest.approx(0.064)


def test_the_new_entries_are_appended_with_their_cells():
    bench = _bench()
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"][-len(NEW):]:
        assert set(m["workloads"]) <= cells
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           m["name"] + ".py"))
