"""Quick single-model train-step timing on the card, the suite's pipelined
protocol (port of ``scripts/bench_step.py``)::

    python -m tecogan_tpu_torch.tools.bench_step [frvsr|tecogan] [--fp32]

Mixed precision unless ``--fp32``; the geometry is
``bench_suite.build_train_case``'s (batch 4 x 10 frames of 128^2 GT, nf=64,
nb=10, 4x BD). The JAX script's ``--unroll`` (XLA's scan unrolling) has no
counterpart.
"""

from __future__ import annotations

import argparse

from .bench_suite import _train_iter, card_line


def main(argv=None, device=None):
    """Returns the seconds per step; ``device="cpu"`` runs on the CPU."""
    ap = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.bench_step")
    ap.add_argument("model", nargs="?", default="tecogan",
                    choices=["frvsr", "tecogan"])
    ap.add_argument("--fp32", action="store_true",
                    help="train in fp32 instead of mixed precision")
    args = ap.parse_args(argv)
    mixed = not args.fp32
    t = _train_iter(args.model, mixed_precision=mixed, device=device)
    print(f"{args.model} {'bf16' if mixed else 'fp32'}: {t * 1000:.1f} "
          f"ms/iter on {card_line(device)}")
    return t


if __name__ == "__main__":
    main()
