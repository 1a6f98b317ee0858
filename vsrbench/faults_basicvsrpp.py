"""Readings of faults planted in the program's BasicVSR++, for the limits of
a BasicVSR++ cell's correctness check (beside ``calibrate.py``, whose
program and control readings serve this cell as they are):

    python3 -m vsrbench.faults_basicvsrpp --workload <cell> \
        --faults offset_flow_only,mask_const,no_second_order,frozen,repeat \
        --fault_seeds 4 5 6 --out <file.jsonl>

One JSON line per reading, to standard output and to ``--out``, with
``correct`` and ``over`` as the cell's committed limits judge it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import calibrate, harness

FAULTS = ("offset_flow_only", "mask_const", "no_second_order", "frozen",
          "repeat")


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the program for the length of the block:
    ``offset_flow_only`` (the DCN's offsets are the flows alone: the
    10 tanh residual dropped), ``mask_const`` (every DCN mask 0.5),
    ``no_second_order`` (every alignment as at a branch's second step:
    p2, c2 and f2 zero), ``frozen`` (the carried feature reset at every
    step: each alignment sees zeros for it and for p2), ``repeat`` (every
    fifth output frame repeats the frame before it)."""
    from tecogan_tpu_torch.models import networks
    from tecogan_tpu_torch.models.networks import basicvsrpp

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    dcn = basicvsrpp.modulated_deform_conv
    align = basicvsrpp.BasicVSRPP.align
    if fault == "offset_flow_only":
        patch(basicvsrpp, "modulated_deform_conv",
              lambda x, raw, f1, f2, w, b, mag, groups: dcn(
                  x, raw, f1, f2, w, b, 0.0, groups))
    elif fault == "mask_const":
        def half_mask(x, raw, f1, f2, w, b, mag, groups):
            raw = raw.clone()
            raw[:, 18 * groups:] = 0.0  # sigmoid(0) = 0.5
            return dcn(x, raw, f1, f2, w, b, mag, groups)
        patch(basicvsrpp, "modulated_deform_conv", half_mask)
    elif fault == "no_second_order":
        patch(basicvsrpp.BasicVSRPP, "align",
              lambda self, name, prop, spatial, f1, second: align(
                  self, name, prop, spatial, f1, None))
    elif fault == "frozen":
        patch(basicvsrpp.BasicVSRPP, "align",
              lambda self, name, prop, spatial, f1, second: align(
                  self, name, torch.zeros_like(prop), spatial, f1, None))
    elif fault == "repeat":
        infer = networks.infer_clip_batch

        def repeating(*args, **kwargs):
            out = infer(*args, **kwargs)
            with torch.inference_mode():
                out[:, 4::5] = out[:, 3::5][:, :out[:, 4::5].shape[1]]
            return out
        patch(networks, "infer_clip_batch", repeating)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vsrbench.faults_basicvsrpp")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--fault_seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_json("BENCHMARK.json"),
                             args.workload)
    out = open(args.out, "a") if args.out else None
    for fault in filter(None, args.faults.split(",")):
        for seed in args.fault_seeds:
            with planted(fault):
                got = calibrate.program_reading(cell, seed, device)
            line = json.dumps({"cell": args.workload,
                               "role": f"fault:{fault}", "seed": seed,
                               **calibrate.judged(cell, got), **got})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
