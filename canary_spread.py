"""Spread of the perf canary's three metrics across processes, on an idle
host and on one whose cores are busy, on one card.

    python3 canary_spread.py [--runs N] [--load L [L ...]]

For each load L (default 0, then 4 and 8) it starts L busy-loop processes
on the host's cores, runs N fresh processes (default 3) that each measure
``tecogan_tpu_torch.tools.bench_suite.measure_headline`` (the canary's
bf16 4x BD FPS, FRVSR and TecoGAN ms/step) with a host probe before and
after it (microseconds a launch of 2000 in-place adds on a 16-element
tensor and one sync, min of 5 rounds), then stops the busy loops. A
one-card machine shares its host's cores with other machines; the loaded
turns show how far a busy host moves each metric and the probe. Prints
each process's readings, then one JSON line with every reading by load
and the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

_CHILD = r"""
import json, time, torch
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.tools import bench_suite
kernel_build.build()
x = torch.zeros(16, device="cuda")
def one_round():
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    torch.cuda.synchronize()
    return time.perf_counter() - t0
def probe_us():
    one_round()
    return 1e6 * min(one_round() for _ in range(5)) / 2000
before = probe_us()
out = bench_suite.measure_headline()
out["host_probe_us"] = [before, probe_us()]
print(json.dumps(out))
"""


def _measure() -> dict:
    res = subprocess.run([sys.executable, "-c", _CHILD],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the measuring process failed:\n"
                           f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 canary_spread.py")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--load", type=int, nargs="+", default=[0, 4, 8])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("canary_spread: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    readings = {}
    for load in args.load:
        busy = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
                for _ in range(load)]
        try:
            runs = [_measure() for _ in range(args.runs)]
        finally:
            for p in busy:
                p.kill()
                p.wait()
        readings[load] = runs
        for r in runs:
            print(f"load {load}: FPS {r['infer_bf16_4x_bd_fps']:.2f}, FRVSR "
                  f"{r['frvsr_train_ms']:.2f} ms, TecoGAN "
                  f"{r['tecogan_train_ms']:.2f} ms, host probe "
                  f"{r['host_probe_us']} us on {card}", flush=True)
    print(json.dumps({"card": card, "readings": readings}))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
