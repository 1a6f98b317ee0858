"""Live streaming FPS of checkouts of the port, in turns on one card.

    python3 fps_turns.py TREE [TREE ...] [--rounds N]

Each TREE is the root of a checkout of this repository (``.`` for this
one; an older commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists). Each turn runs, in a fresh process from its tree,
bench.py's protocol on ``infer_sequence_batch``: the flagship generator
(nf=64, nb=10, 4x BD, bf16) with weights from seed 0, one stream of 64 LR
frames of 134x320, chunk 64, one warm-up, the min of 5 runs, a checksum
read back to force the sync. The trees take turns forward then back (A B
B A for two), ``--rounds`` times. Prints each turn's frames/s, then one
JSON line with every tree's turns, and the card's name and power limit.
Needs a CUDA card; builds each tree's kernels in its own build directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, time, torch
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
kernel_build.build()
cfg = FRNetConfig(compute_dtype="bfloat16")
net = FRNet.random(cfg, torch.Generator().manual_seed(0), device="cuda")
gen = torch.Generator(device="cuda").manual_seed(1)
lr = torch.rand((1, 64, 134, 320, 3), generator=gen, device="cuda")
def run(x):
    return int(infer_sequence_batch(net, x, cfg, chunk=64)
               .sum(dtype=torch.int64).item())
run(lr)
times = []
for rep in range(5):
    x = lr + (rep + 1) * 1e-6
    t0 = time.perf_counter()
    run(x)
    times.append(time.perf_counter() - t0)
print(json.dumps({"fps": 64 / min(times),
                  "ms": [round(t * 1e3, 2) for t in times]}))
"""


def _turn(tree: str) -> dict:
    tree = os.path.abspath(tree)
    res = subprocess.run([sys.executable, "-c", _TURN], cwd=tree,
                         env={**os.environ, "PYTHONPATH": tree},
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"the turn in {tree} failed:\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 fps_turns.py")
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fps_turns: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    order = args.trees + args.trees[::-1]
    fps = {t: [] for t in args.trees}
    for r in range(args.rounds):
        for tree in order:
            out = _turn(tree)
            fps[tree].append(out["fps"])
            print(f"round {r} {tree}: {out['fps']:.2f} frames/s (runs ms "
                  f"{out['ms']}) on {card}", flush=True)
    print(json.dumps({"fps": fps, "min_of_turns": {
        t: min(v) for t, v in fps.items()}, "max_of_turns": {
        t: max(v) for t, v in fps.items()}}))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
