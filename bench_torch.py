"""Benchmark of the PyTorch/CUDA port: streaming 4x SR inference throughput
on one card (the counterpart of ``bench.py``, which measures the JAX
package on a TPU and stays as it is).

    python3 bench_torch.py

Protocol (``bench.py``'s): 64 RGB frames of 134x320 LR through the
flagship generator (FRNet, nf=64, nb=10, 4x, BD), bf16, the whole clip as
one chunk, one warm-up, min of 5 timed runs, each forced by a device-side
checksum read back. The recipe is ``tecogan_tpu_torch/tools/bench_suite.
_fps_infer``. The reference reports 27 FPS on one GTX 1080Ti
(SURVEY.md §6); ``vs_baseline`` is the speed-up over that.

Prints the card's name and power limit and K1's launches on earlier
lines, then ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
Runs on the card; without one it exits 2 and prints no result.
"""

import json
import sys

METRIC = "torch_4x_bd_sr_fps_134x320"


def main(device=None) -> int:
    """``device``: None for the card; ``"cpu"`` runs the same protocol on
    the CPU, explicitly."""
    import torch

    if device is None and not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 2
    from tecogan_tpu_torch.ops.warp_cuda import warp_planes
    from tecogan_tpu_torch.tools import bench_suite

    before = warp_planes.launches
    fps = bench_suite._fps_infer("bfloat16", device=device, reps=5)
    print(f"card: {bench_suite.card_line(device)}")
    print(f"warp_planes launches: {warp_planes.launches - before}")
    print(json.dumps({
        "metric": METRIC,
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 27.0, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
