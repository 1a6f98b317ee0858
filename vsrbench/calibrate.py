"""Readings for the limits of a cell's correctness check, on the card at the
cell's own size: the program against the plain reference on many seeds
(the lower readings), the control (the reference with every convolution
and linear operand rounded to fp8 e4m3, gradients to e5m2, the precision
below the configuration's bf16) against the fp32 reference (the upper
readings), planted faults of the program, and probes (the reference with
one value rounded to bf16, to find where the bf16 program departs):

    python3 -m vsrbench.calibrate --workload <cell> --seeds 1 2 ... \
        --control 7 8 9 --faults half,frozen,dflow --fault_seeds 4 5 6 \
        --probes tanh,flow,frame --probe_seeds 3 --out <file.jsonl>

One JSON line per reading, to standard output and to ``--out``, with
``correct`` and ``over`` (the numbers over their limits) as the cell's
committed limits judge it. The window is not timed: it runs up to the
unit that the check samples.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from . import harness


@contextlib.contextmanager
def planted(fault: str):
    """A fault planted in the program for the length of the block:
    ``frozen`` (a step that returns its state unchanged: the optimizer
    step skipped, or inference's HR carry never updated), ``half`` (half
    of the batch left out: a training step on the first half, the mean
    taken over it; inference on the first half of the streams, the rest
    zeros), ``repeat`` (an answer altered where it is produced: every
    fifth output frame repeats the frame before it), ``dflow`` (every
    adjoint of a warp with respect to its flow zeroed: K4's and the fused
    K3+K4's), ``dflow_fused`` (the fused K3+K4's alone)."""
    from tecogan_tpu_torch.models import networks, steps
    from tecogan_tpu_torch.models.networks import frnet
    from tecogan_tpu_torch.ops import warp_vjp

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "frozen":
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
        patch(frnet, "warp_planes",
              lambda planes, flow, **kw: torch.zeros_like(planes))
    elif fault == "half":
        for name in ("frvsr_train_step", "tecogan_train_step"):
            step = getattr(steps, name)

            def halved(state, batch, _step=step, **kw):
                n = batch["gt"].shape[0] // 2
                return _step(state, {k: v[:n] for k, v in batch.items()},
                             **kw)
            patch(steps, name, halved)
        infer = frnet.infer_sequence_batch

        def half_infer(net, lr, cfg, chunk=16, fold_streams=False):
            n = lr.shape[0] // 2
            out = infer(net, lr[:n], cfg, chunk, fold_streams)
            return torch.cat([out, torch.zeros_like(out)], 0)
        patch(networks, "infer_sequence_batch", half_infer)
    elif fault == "repeat":
        quantize = frnet.quantize_uint8
        calls = {"n": 0}

        def repeating(x):
            calls["n"] += 1
            if calls["n"] % 5 == 0 and "last" in calls:
                return calls["last"].clone()
            calls["last"] = quantize(x)
            return calls["last"]
        patch(frnet, "quantize_uint8", repeating)
    elif fault in ("dflow", "dflow_fused"):
        fused = warp_vjp.warp_dimage_dflow
        patch(warp_vjp, "warp_dimage_dflow", lambda g, x, flow: (
            fused(g, x, flow)[0], torch.zeros_like(flow)))
        if fault == "dflow":
            patch(warp_vjp, "warp_dflow",
                  lambda g, x, flow: torch.zeros_like(flow))
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def driven(cell: dict, seed: int, device):
    """The cell's driver on ``seed``, run up to the unit its check samples,
    with the program's state freed."""
    drv = harness.driver(cell["mix"]["driver"]).Driver(
        cell["config_data"], cell["mix"], seed, device)
    while drv.pending():
        drv.unit()
    drv.release()
    return drv


def flow_stats(drv) -> dict:
    """Where the reference's first LR flow (FNet at the seed's weights on
    the first checked batch) sits: its mean magnitude, and the share of
    its HR components within 1/64 pixel of a whole pixel, where the
    bilinear warp's derivative with respect to the flow jumps from one
    neighbour's difference to the other's (bf16 spaces values of 4-8
    pixels 1/32 apart)."""
    from .reference import nets as ref
    from .reference import train as ref_train

    scale = drv.dims[2]
    g = ref.load(ref.FRNet(*drv.dims), drv.sd["g"], drv.device).eval()
    _, lr = ref_train._prepare(drv.checked[0][0],
                               scale, drv.config["degradation"]["sigma"])
    n, t, c, h, w = lr.shape
    with torch.no_grad(), ref_train.no_tf32():
        flow = g.fnet(lr[:, 1:].reshape(-1, c, h, w),
                      lr[:, :-1].reshape(-1, c, h, w))
        hr = g.hr_flow(flow, h, w)
    frac = (hr - hr.round()).abs()
    return {"flow.lr_abs_mean": float(flow.abs().mean()),
            "flow.hr_near_whole": float((frac < 1.0 / 64).float().mean())}


def program_reading(cell: dict, seed: int, device) -> dict:
    """The program's numbers on ``seed`` (as a run's check computes them,
    every number, not only those with a limit)."""
    drv = driven(cell, seed, device)
    if drv.kind == "infer":
        from .drivers.infer_batch import readings
        x, out = drv.kept
        return readings(out, drv.reference(x))
    left_out = cell["limits"].get("loss_terms_left_out", ())
    return {**drv.compare(drv.program_pair(), drv.reference_pair(),
                          left_out), **flow_stats(drv)}


def control_reading(cell: dict, seed: int, device,
                    rounding: str = "fp8") -> dict:
    """The control's numbers on ``seed``: the reference in fp8 in the
    program's place (``rounding``: a probe's name instead, the reference
    with one value in bf16)."""
    drv = driven(cell, seed, device)
    if drv.kind == "infer":
        from .drivers.infer_batch import readings
        x = drv.kept[0]
        return readings(drv.reference(x, rounding), drv.reference(x))
    low = drv.reference_pair(rounding, votes=(None, None))
    high = drv.reference_pair(votes=(low[0][3], low[1][3]))
    return drv.compare(low, high, cell["limits"].get("loss_terms_left_out",
                                                     ()))


def judged(cell: dict, got: dict) -> dict:
    """``correct`` and ``over`` of a reading at the cell's limits."""
    checks = [{"name": k, "value": got.get(k), "limit": v}
              for k, v in cell["limits"]["checks"].items()]
    return {"correct": harness.verdict(checks),
            "over": [c["name"] for c in checks if not harness.verdict([c])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m vsrbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--probes", default="")
    ap.add_argument("--probe_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.find_cell(harness.load_json("BENCHMARK.json"),
                             args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(role, seed, got):
        line = json.dumps({"cell": args.workload, "role": role,
                           "seed": seed, **judged(cell, got), **got})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in args.seeds:
        emit("program", seed, program_reading(cell, seed, device))
    for seed in args.control:
        emit("control", seed, control_reading(cell, seed, device))
    for probe in filter(None, args.probes.split(",")):
        for seed in args.probe_seeds:
            emit(f"probe:{probe}", seed,
                 control_reading(cell, seed, device, probe))
    for fault in filter(None, args.faults.split(",")):
        for seed in args.fault_seeds:
            with planted(fault):
                emit(f"fault:{fault}", seed,
                     program_reading(cell, seed, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
