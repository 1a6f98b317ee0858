"""Benchmark evaluation entry (port of
``tecogan_tpu/official_metrics/evaluate.py``; reference contract
`codes/official_metrics/evaluate.py`): maps a model name to the Vid4/ToS3
result/GT directory lists and runs the metric harness.

Usage: python -m tecogan_tpu_torch.official_metrics.evaluate \
    -m TecoGAN_BD_iter500000 [--gpu_ids -1]

LPIPS runs on card 0 unless ``--gpu_ids -1`` asks for the CPU; without
CUDA it raises.
"""

from __future__ import annotations

import argparse
import os.path as osp

from .metrics import device_from_gpu_ids, evaluate_folders

VID4_SEQS = ["calendar", "city", "foliage", "walk"]
TOS3_SEQS = ["bridge", "face", "room"]


def main(argv=None):
    """Returns {dataset: evaluate_folders' summary}."""
    p = argparse.ArgumentParser()
    p.add_argument("--model", "-m", type=str, required=True)
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="the card LPIPS runs on (-1 for the CPU)")
    args = p.parse_args(argv)

    keys = args.model.split("_")
    if len(keys) < 2 or keys[0] not in ("TecoGAN", "FRVSR") \
            or keys[1] not in ("BD", "BI"):
        raise SystemExit(
            f"model must be named (TecoGAN|FRVSR)_(BD|BI)_*, got "
            f"{args.model!r}")
    device = device_from_gpu_ids(args.gpu_ids)

    summaries = {}
    for ds, seqs in (("Vid4", VID4_SEQS), ("ToS3", TOS3_SEQS)):
        gt_dir = f"data/{ds}/GT"
        sr_dir = f"results/{ds}/{args.model}"
        if not osp.exists(sr_dir):
            continue
        summaries[ds] = evaluate_folders(
            [osp.join(sr_dir, s) for s in seqs],
            [osp.join(gt_dir, s) for s in seqs],
            osp.join(sr_dir, "metric_log"), device=device)
    if not summaries:
        # exiting 0 with no output on a typo'd model name reads as a
        # passing evaluation
        raise SystemExit(
            f"no results found under results/Vid4/{args.model} or "
            f"results/ToS3/{args.model} -- check the model name and cwd")
    return summaries


if __name__ == "__main__":
    main()
