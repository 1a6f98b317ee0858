"""Where a benchmark cell's device time and idle time fall among the port's
own spans, read from one profiled sub-window on the card.

    python3 span_split.py --workload <cell> [--seed N] [--seconds S]
        [--units U] [--out DIR]

Sets the cell up as ``python3 -m vsrbench.run`` does, runs its traffic for
``--seconds`` (the loader and the card reach their steady pace), then runs
``--units`` more units under ``torch.profiler`` and reduces the profile:

- ``device_copies``: device events named after a ``tecogan.`` span (none
  are expected: the port's spans are operator-scope ranges) beside those
  of the harness's user-scope ``vsrbench.`` ranges;
- ``in_spans``: the share of device time from kernels whose launch (the
  CUDA runtime or driver call that kineto links to the kernel by its
  correlation id) falls inside a ``tecogan.`` span on any thread, and the
  kernels with no launch event, by name;
- ``by_span``: for each innermost ``tecogan.`` span around a launch, the
  device seconds of the kernels launched there; and the device idle
  seconds inside each innermost span (a gap's share that the span's
  host interval covers);
- ``idle_gaps``: the ten longest idle gaps, each named by the harness's
  span, the innermost program span and the innermost other host range at
  its midpoint;
- ``clock``: the largest gap between a span's start as the program keeps it
  (``tracing.spans()``) and as kineto recorded it;
- ``marks``: for each span name, the device ms between the span's marks
  (``SpanRecord.device_ms``) beside the device time of the kernels
  launched inside it;
- ``counters``: the program's counters over the measured seconds and the
  profiled units (deltas), and since the process started.

Writes ``<out>/<cell>.json`` (default ``build/span_split``) and prints a
summary. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from vsrbench.trace import _union

LAUNCH_PREFIXES = ("cuda", "cu")


def _events(prof):
    """(is_device, name, start_ns, end_ns, correlation) of every event of
    the profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append((e.device_type() == cuda, e.name(), e.start_ns(),
                    e.start_ns() + e.duration_ns(), e.correlation_id()))
    return out


def _innermost(ranges, t):
    """The name of the latest-starting (start, end, name) range around t."""
    best = None
    for s, e, n in ranges:
        if s <= t <= e and (best is None or s >= best[0]):
            best = (s, n)
    return None if best is None else best[1]


def reduce(events, t0, t1, program):
    """The report's reductions of one profile (``events`` from
    ``_events``; the window [t0, t1]; ``program``: the program's kept
    spans of the window)."""
    dev = [ev for ev in events if ev[0] and ev[3] > ev[2]]
    host = [ev for ev in events if not ev[0] and ev[3] >= ev[2]]
    copies = {}
    for _, n, s, e, _ in dev:
        for p in ("tecogan.", "vsrbench."):
            if n.startswith(p):
                copies[p] = copies.get(p, 0) + 1
    kernels = [ev for ev in dev if not ev[1].startswith(
        ("tecogan.", "vsrbench."))]
    spans = [(s, e, n) for _, n, s, e, _ in host
             if n.startswith("tecogan.")]
    harness = [(s, e, n) for _, n, s, e, _ in host
               if n.startswith("vsrbench.")]
    others = [(s, e, n) for _, n, s, e, _ in host
              if not n.startswith(("tecogan.", "vsrbench."))]
    launches = {}
    for _, n, s, e, corr in host:
        if corr and n.startswith(LAUNCH_PREFIXES):
            launches[corr] = s
    total = sum(e - s for _, _, s, e, _ in kernels)
    inside, unlinked, by_span = 0, {}, {}
    for _, n, s, e, corr in kernels:
        t = launches.get(corr)
        if t is None:
            unlinked[n] = unlinked.get(n, 0) + (e - s) / 1e9
            continue
        name = _innermost(spans, t)
        if name is not None:
            inside += e - s
            by_span[name] = by_span.get(name, 0) + (e - s) / 1e9
    merged = _union([(s, e) for _, _, s, e, _ in kernels])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        gaps = [(t0, merged[0][0])] + gaps + [(merged[-1][1], t1)]
    gaps = [g for g in gaps if g[1] > g[0]]
    idle_by_span = {}
    for a, b in gaps:
        # each program span's share of the gap: the part its host interval
        # covers that no later-starting span covers
        cuts = sorted({a, b} | {min(max(x, a), b) for s, e, _ in spans
                                if s < b and e > a for x in (s, e)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid = (lo + hi) // 2
            name = _innermost(spans, mid) or "outside tecogan spans"
            idle_by_span[name] = idle_by_span.get(name, 0) + (hi - lo) / 1e9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in longest:
        mid = (a + b) // 2
        parts = [_innermost(harness, mid), _innermost(spans, mid),
                 _innermost(others, mid)]
        named.append([" / ".join(p for p in parts if p) or "host idle",
                      (b - a) / 1e9])
    kineto_starts = {}
    for s, e, n in spans:
        kineto_starts.setdefault(n, []).append(s)
    offsets = []
    for rec in program:
        starts = kineto_starts.get("tecogan." + rec.name, [])
        if starts:
            offsets.append(min(abs(rec.start_ns - s) for s in starts))
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": sum(e - s for s, e in merged) / 1e9,
        "device_s": total / 1e9,
        "device_copies": copies,
        "kernels": len(kernels),
        "launch_events": len(launches),
        "in_spans": {"share": inside / total if total else None,
                     "unlinked_s": dict(sorted(unlinked.items(),
                                               key=lambda kv: -kv[1]))},
        "by_span": {"device_s": dict(sorted(by_span.items())),
                    "idle_s": dict(sorted(idle_by_span.items()))},
        "idle_gaps": named,
        "clock": {"spans_matched": len(offsets),
                  "max_offset_us": max(offsets) / 1e3 if offsets else None},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 span_split.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147500001)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--units", type=int, default=1)
    ap.add_argument("--out", default=os.path.join("build", "span_split"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.utils import tracing
    from vsrbench import harness
    from vsrbench.run import card_power_limit

    if not torch.cuda.is_available():
        print("span_split.py needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_json("BENCHMARK.json"),
                             args.workload)
    drv = harness.driver(cell["mix"]["driver"]).Driver(
        cell["config_data"], cell["mix"], args.seed, device)
    c0 = tracing.counters()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        drv.unit()
    torch.cuda.synchronize(device)
    c1 = tracing.counters()
    n_log = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("vsrbench.traced_window"):
            for _ in range(args.units):
                drv.unit()
            torch.cuda.synchronize(device)
    c2 = tracing.counters()
    program = tracing.spans()[n_log:]
    events = _events(prof)
    marks = [(s, e) for d, n, s, e, _ in events
             if not d and n == "vsrbench.traced_window"]
    out = reduce(events, marks[0][0], marks[0][1], program)
    by_name = {}
    for rec in program:
        ms = rec.device_ms()
        if ms is not None:
            by_name[rec.name] = by_name.get(rec.name, 0.0) + ms
    out["marks"] = {"device_ms": by_name,
                    "launched_ms": {k[len("tecogan."):]: 1e3 * v for k, v
                                    in out["by_span"]["device_s"].items()}}
    out["counters"] = {
        "window": {k: c1[k] - c0[k] for k in c1},
        "profiled": {k: c2[k] - c1[k] for k in c2},
        "process": c2}
    out["spans_kept"] = len(program)
    out["card"] = [torch.cuda.get_device_name(device), card_power_limit(),
                   torch.__version__]
    out["workload"], out["seed"] = args.workload, args.seed
    drv.release()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, args.workload + ".json"), "w") as f:
        json.dump(out, f, indent=1)
    summary = {k: out[k] for k in ("workload", "card", "window_s", "busy_s",
                                   "device_copies", "in_spans", "clock",
                                   "counters")}
    summary["idle_s"] = out["by_span"]["idle_s"]
    summary["marks"] = out["marks"]
    summary["idle_gaps"] = out["idle_gaps"][:5]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
