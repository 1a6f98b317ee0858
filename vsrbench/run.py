"""Run one cell of the benchmark on the card and print its result line.

    python3 -m vsrbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Set-up (the
program's import, its kernel library, seeded weights and inputs, warm-up)
runs first; then the cell's traffic runs for ``--seconds``, one
synchronous unit at a time (a batched inference call read back by a
checksum, or a group of training steps read back by a log value), and on
until the unit that the check samples has run; with ``--trace 1`` a
profiled sub-window and the per-layer readings follow.
Once the window has closed the program's state is freed and the plain
reference judges a sample of what the window produced. Standard error ends
with each compared number beside its limit; standard output ends with one
JSON object. Without a card (or with fewer than the cell asks for) the run
prints no result and exits 2; with JAX or the JAX package loaded, 4.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (from /proc; since this module
    was imported where /proc cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def card_power_limit() -> str:
    import subprocess
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def traced(drv, device) -> dict:
    """The driver's traced sub-window (``drv.trace()``'s record) with what
    any metric reader may use besides: ``memory_peak_bytes``, the device
    memory peak over it (from a reset before it), and ``launches``, the
    program's kernel launches in it by kernel."""
    import torch
    from tecogan_tpu_torch.ops import kernel_launches

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    before = kernel_launches()
    rec = drv.trace()
    after = kernel_launches()
    rec["launches"] = {k: after[k] - before[k] for k in after}
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)
    return rec


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device) -> int:
    """Set up, measure, trace, judge and print one run of ``cell`` on
    ``device``. Returns the exit code."""
    import torch

    from . import harness

    drv = harness.driver(cell["mix"]["driver"]).Driver(
        cell["config_data"], cell["mix"], seed, device)
    setup_s = process_age()
    units = attempted = 0
    t0 = time.perf_counter()
    while True:
        units += drv.unit()
        attempted += 1
        if time.perf_counter() - t0 >= seconds and not drv.pending():
            break
    window_s = time.perf_counter() - t0
    rates = drv.rates(units, window_s)
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec = traced(drv, device) if trace else None
    if trace:
        peak = max(peak, rec["memory_peak_bytes"])
    drv.release()
    t_ref = time.perf_counter()
    checks = drv.check(cell["limits"])
    correct = harness.verdict(checks)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s, process peak "
          f"{torch.cuda.max_memory_allocated(device) if on_card else 0} B",
          file=sys.stderr, flush=True)

    if trace:
        metrics = harness.read_metrics(cell["per_layer"], rec,
                                       cell.get("root", harness.HERE))
    else:
        e2e = {m["name"]: m for m in cell["end_to_end"]}
        values = dict(rates, setup_s=setup_s)
        metrics = {k: {"value": float(values[k]), "unit": e2e[k]["unit"]}
                   for k in e2e}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": card_power_limit() if on_card else "none"}
    breakdown = None
    if trace:
        tr = rec["trace"]
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        breakdown = tr.breakdown()

    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: loaded modules {bad} (JAX or the JAX package)",
              file=sys.stderr, flush=True)
        return 4
    print("\n".join(harness.check_lines(checks)), file=sys.stderr,
          flush=True)
    print(harness.result_line(correct, attempted, 0, metrics, dev, checks,
                              breakdown), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vsrbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness
    try:
        bench = harness.load_json("BENCHMARK.json")
        cell = harness.find_cell(bench, args.workload)
        import torch
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            raise harness.Refused(
                f"the cell needs {cell['chips']} CUDA device(s); "
                f"torch sees {torch.cuda.device_count()}")
    except (harness.Refused, OSError, KeyError, ValueError) as e:
        print(f"refused: {e}", file=sys.stderr, flush=True)
        return 2
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0))


if __name__ == "__main__":
    sys.exit(main())
