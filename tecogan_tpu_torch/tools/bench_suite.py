"""Benchmark suite of the port on one card (port of
``scripts/bench_suite.py``): streaming-inference FPS (bf16 and fp32, the
2x/4x BD/BI family, 4 streams batched), train-step time (FRVSR and TecoGAN
at the reference's batch geometry, the family, without remat, in fp32) and
the host loader's rate::

    python -m tecogan_tpu_torch.tools.bench_suite            # the table
    python -m tecogan_tpu_torch.tools.bench_suite --check    # perf canary
    python -m tecogan_tpu_torch.tools.bench_suite --check --update
    python -m tecogan_tpu_torch.tools.bench_suite --headline

The table goes to ``BENCHMARKS_TORCH.md`` at the repository's root (never
``BENCHMARKS.md``, which holds the JAX package's TPU rows); its header
names the card and its power limit, and what stands below the manual
evidence marker is kept across regenerations. ``--check`` measures the
three headline metrics and holds them against the bands of
``tools/perf_canary.json``; ``--update`` then writes the measured values
as the new baselines, and only after a check that passed (a failing run
never becomes the baseline). ``--headline`` prints the three metrics as
one JSON line: the readings the canary's bands are set from.

Every function measures on the card unless its ``device`` argument asks
for the CPU (the tests run them there at toy widths); without a card and
without that request it raises. The JAX script's ``train_unroll`` is
XLA's unrolling of the training scan and has no counterpart here: the
port's frame loop is Python, so the option is gone.

Protocols are the JAX script's: inference rows run 64 LR frames of
134x320 as one chunk, one warm-up, min of 4 timed runs, each forced by a
checksum read back (the batched row: 4 streams x 32 frames, chunk 16);
train rows enqueue 4 steps a sync, min of 3 such rounds after a warm-up
step.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import os.path as osp
import subprocess
import tempfile
import time

import numpy as np

from . import resolve_device

__all__ = ["build_train_case", "card_line", "check_canary", "main",
           "measure_headline"]

_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
_CANARY_PATH = osp.join(osp.dirname(osp.abspath(__file__)),
                        "perf_canary.json")
_TABLE_PATH = osp.join(_REPO, "BENCHMARKS_TORCH.md")
_MANUAL_MARKER = ("<!-- manual evidence below: preserved across "
                  "bench_suite regenerations -->")

# dense bf16 tensor-core peaks (no sparsity) from NVIDIA's H100 data sheet,
# by the name the card reports; a card not listed gets no MFU
BF16_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM5
    "NVIDIA H100 PCIe": 756e12,
}


def card_line(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them ("cpu" for the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[dev.index or 0]


def _timed_checksums(run, x, reps):
    """One warm-up, then ``reps`` runs on inputs nudged by (rep + 1) * 1e-6
    (defeats any input-level caching); min seconds. ``run`` returns a
    device checksum whose ``.item()`` forces the run."""
    run(x).item()
    times = []
    for rep in range(reps):
        xr = x + (rep + 1) * 1e-6
        t0 = time.perf_counter()
        run(xr).item()
        times.append(time.perf_counter() - t0)
    return min(times)


def _fps_infer(dtype, scale=4, degradation="BD", device=None, *, reps=4,
               nf=64, nb=10, frames=64, height=134, width=320):
    """Streaming SR frames/s of one stream: ``frames`` LR frames of
    ``height`` x ``width`` as one chunk, random weights and frames from
    seeds 0 and 1 (``scripts/bench_suite.py::_fps_infer``; ``bench_torch.py``
    runs it with ``reps=5``, ``bench.py``'s protocol)."""
    import torch

    from ..models.networks import FRNet, FRNetConfig, infer_sequence

    dev = resolve_device(device)
    cfg = FRNetConfig(nf=nf, nb=nb, scale=scale, degradation=degradation,
                      compute_dtype=dtype)
    net = FRNet.random(cfg, torch.Generator().manual_seed(0), dev).to(
        cfg.dtype)
    lr = torch.rand((frames, height, width, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)

    def run(x):
        return infer_sequence(net, x, cfg, chunk=frames).sum(
            dtype=torch.int64)

    return frames / _timed_checksums(run, lr, reps)


def _fps_infer_batch(n_streams, device=None, *, reps=4, nf=64, nb=10,
                     frames=32, height=134, width=320, chunk=16):
    """Aggregate frames/s of ``n_streams`` independent bf16 streams in one
    batched call (``scripts/bench_suite.py::_fps_infer_batch``)."""
    import torch

    from ..models.networks import FRNet, FRNetConfig, infer_sequence_batch

    dev = resolve_device(device)
    cfg = FRNetConfig(nf=nf, nb=nb, scale=4, degradation="BD",
                      compute_dtype="bfloat16")
    net = FRNet.random(cfg, torch.Generator().manual_seed(0), dev).to(
        cfg.dtype)
    lr = torch.rand((n_streams, frames, height, width, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)

    def run(x):
        return infer_sequence_batch(net, x, cfg, chunk=chunk).sum(
            dtype=torch.int64)

    return n_streams * frames / _timed_checksums(run, lr, reps)


def build_train_case(model, mixed_precision=False, remat=True, scale=4,
                     degradation="BD", device=None, *, nf=64, nb=10,
                     batch=4, frames=10, gt_size=128):
    """The reference-geometry train-step case (batch 4 x 10 frames of a
    128^2 GT crop; ``scripts/bench_suite.py::build_train_case``): BD ships
    the 8-pixel blur border on the GT (136^2, the LR made on the device in
    the step), BI the paired 128^2 GT and its LR, as in
    ``experiments_BI/*/train.yml``. The uint8 batch is the JAX recipe's
    numpy draws from seed 0; the weights are drawn from torch seeds (the
    generator 0, the discriminator 1, VGG19 2).

    Returns ``(step, state, batch)``: ``step(state, batch)`` runs one
    training step in place and returns ``(state, logs)`` (TecoGAN's VGG19
    is bound into it)."""
    import torch

    from ..models import schedules, steps
    from ..models.networks import (VGG19, DTrunk, FRNet, FRNetConfig,
                                   STNetConfig)
    from ..ops.degrade import bd_border_size

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    if degradation == "BD":
        gt = gt_size + 2 * bd_border_size(1.5)
        arrays = {"gt": (rng.random((batch, frames, gt, gt, 3))
                         * 255).astype(np.uint8)}
    else:
        lhw = gt_size // scale
        arrays = {"gt": (rng.random((batch, frames, gt_size, gt_size, 3))
                         * 255).astype(np.uint8),
                  "lr": (rng.random((batch, frames, lhw, lhw, 3))
                         * 255).astype(np.uint8)}
    data = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    cfg_g = FRNetConfig(nf=nf, nb=nb, scale=scale, degradation=degradation,
                        remat=remat)
    cb = {"type": "CB", "weight": 1, "reduction": "mean"}
    base = dict(scale=scale, degradation=degradation, sigma=1.5,
                tempo_extent=frames, mixed_precision=mixed_precision,
                pixel_crit=cb, warping_crit=cb)
    net_g = FRNet.random(cfg_g, torch.Generator().manual_seed(0),
                         dev).train()
    opt_g, sched_g = schedules.make_adam({"lr": 1e-4}, net_g.parameters())
    if model == "frvsr":
        state = steps.frvsr_init_state(net_g, opt_g)
        step = functools.partial(steps.frvsr_train_step, cfg_g=cfg_g,
                                 tcfg=steps.TrainConfig(**base),
                                 sched_g=sched_g)
        return step, state, data
    if model != "tecogan":
        raise ValueError(f"model must be frvsr or tecogan, got {model!r}")
    cfg_d = STNetConfig(spatial_size=gt_size)
    tcfg = steps.TrainConfig(
        **base,
        feature_crit={"type": "CosineSimilarity", "weight": 0.2,
                      "feature_layers": [8, 17, 26, 35]},
        pingpong_crit={"type": "CB", "weight": 0.5, "reduction": "mean"},
        gan_crit={"type": "GAN", "weight": 0.01, "reduction": "mean"},
        update_policy="adaptive")
    net_d = DTrunk.random(cfg_d, torch.Generator().manual_seed(1), dev)
    opt_d, sched_d = schedules.make_adam({"lr": 5e-5}, net_d.parameters())
    vgg = VGG19.random(torch.Generator().manual_seed(2), dev)
    state = steps.tecogan_init_state(net_g, net_d, opt_g, opt_d)
    step = functools.partial(steps.tecogan_train_step, cfg_g=cfg_g,
                             cfg_d=cfg_d, tcfg=tcfg, sched_g=sched_g,
                             sched_d=sched_d, vgg=vgg)
    return step, state, data


def step_flops(step, state, batch) -> float:
    """The FLOPs of one training step as ``torch.utils.flop_counter.
    FlopCounterMode`` counts them (it runs the step, which updates the
    state): convolutions, matrix products and attention-like aten
    operators, in the forward, the backward and, with ``remat``, the
    forward that ``torch.utils.checkpoint`` runs again in the backward.
    The hand-written warp kernels (K1-K5) and elementwise operators are not
    counted."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    return float(counter.get_total_flops())


def _train_iter(model, mixed_precision=False, report_mfu=False, remat=True,
                scale=4, degradation="BD", device=None, **geometry):
    """Seconds per training step, pipelined as the real loop runs (logs
    read once every 4 steps): one warm-up step, then the min over 3 rounds
    of 4 steps (``scripts/bench_suite.py::_train_iter``). With
    ``report_mfu``: ``(seconds, FLOP/s)``, the FLOPs of ``step_flops``
    (counted on one more step, after the timing) over the step time."""
    dev = resolve_device(device)
    step, state, batch = build_train_case(
        model, mixed_precision=mixed_precision, remat=remat, scale=scale,
        degradation=degradation, device=dev, **geometry)
    state, logs = step(state, batch)
    logs["l_pix_G"].item()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(4):
            state, logs = step(state, batch)
        logs["l_pix_G"].item()
        times.append((time.perf_counter() - t0) / 4)
    t_iter = min(times)
    if report_mfu:
        return t_iter, step_flops(step, state, batch) / t_iter
    return t_iter


def _loader_rate(tmpdir, batch_size=4, num_workers=4, threads=None, *,
                 seqs=30, frames=10, size=448, crop=136):
    """Clips/s of the threaded ``TrainLoader`` over a records store of
    ``seqs`` random sequences (136^2 crops of 10 frames, moving first
    frame, uint8) for 3 epochs (``scripts/bench_suite.py::_loader_rate``).
    ``threads`` caps the native assembler's threads a sample for the run
    and restores the prior cap after (no effect where the numpy assembler
    runs). Host work only: no device."""
    from ..data import RecordWriter, TrainLoader, UnpairedClipDataset
    from ..data.native import load_library

    rng = np.random.default_rng(0)
    w = RecordWriter(tmpdir)
    for i in range(seqs):
        w.add_sequence(f"v{i}", (rng.random((frames, size, size, 3))
                                 * 255).astype(np.uint8))
    w.close()
    ds = UnpairedClipDataset(tmpdir, crop_size=crop, tempo_extent=frames,
                             moving_first_frame=True, moving_factor=0.7,
                             output_dtype=np.uint8)
    lib = load_library() if threads is not None else None
    prior = lib.teco_get_max_threads() if lib is not None else None
    if lib is not None:
        lib.teco_set_max_threads(threads)
    try:
        loader = TrainLoader(ds, batch_size=batch_size, seed=0,
                             num_workers=num_workers)
        n, t0 = 0, time.perf_counter()
        for epoch in range(3):
            for _ in loader.epoch(epoch):
                n += 1
        return batch_size * n / (time.perf_counter() - t0)
    finally:
        if lib is not None:
            # the prior cap, so a TECOGAN_LOADER_THREADS setting survives
            lib.teco_set_max_threads(prior)


# ------------------------------------------------------------ perf canary

def measure_headline(device=None) -> dict:
    """The canary's three metrics, measured now: bf16 4x BD streaming FPS,
    FRVSR and TecoGAN ms/step (mixed precision)."""
    return {
        "infer_bf16_4x_bd_fps": _fps_infer("bfloat16", device=device),
        "frvsr_train_ms": 1000 * _train_iter(
            "frvsr", mixed_precision=True, device=device),
        "tecogan_train_ms": 1000 * _train_iter(
            "tecogan", mixed_precision=True, device=device),
    }


def check_canary(update: bool = False, device=None) -> bool:
    """Measure the three headline metrics and hold each against its band
    in ``tools/perf_canary.json``: a floor of ``baseline *
    min_ratio`` for a rate, a ceiling of ``baseline * max_ratio`` for a
    time. Prints the card and a verdict table; True when every metric is
    inside its band. With ``update`` the measured values become the new
    baselines, written only when the check passed."""
    with open(_CANARY_PATH) as f:
        canary = json.load(f)
    measured = measure_headline(device)
    print(f"card: {card_line(device)}")
    print(f"{'metric':<24} {'measured':>10} {'baseline':>10} "
          f"{'bound':>12}  verdict")
    ok = True
    for name, val in measured.items():
        spec = canary[name]
        base = spec["baseline"]
        if "min_ratio" in spec:  # higher is better
            bound = base * spec["min_ratio"]
            good = val >= bound
            bound_s = f">= {bound:.1f}"
        else:  # lower is better
            bound = base * spec["max_ratio"]
            good = val <= bound
            bound_s = f"<= {bound:.1f}"
        ok &= good
        print(f"{name:<24} {val:>10.1f} {base:>10.1f} {bound_s:>12}  "
              f"{'ok' if good else 'REGRESSION'}")
    if update and ok:
        for name, val in measured.items():
            canary[name]["baseline"] = round(val, 1)
        with open(_CANARY_PATH, "w") as f:
            json.dump(canary, f, indent=2)
            f.write("\n")
        print(f"updated baselines -> {_CANARY_PATH}")
    elif update:
        print(f"baselines left as they were: the check failed "
              f"({_CANARY_PATH})")
    print("PERF_CANARY " + ("PASS" if ok else "FAIL"))
    return ok


# ------------------------------------------------------------------ table

def _rows(device):
    rows = []
    fps16 = _fps_infer("bfloat16", device=device)
    rows.append(("4x SR streaming inference, 134x320 LR, bf16",
                 f"{fps16:.1f} frames/s", "reference: 27 FPS on 1080Ti"))
    fps32 = _fps_infer("float32", device=device)
    rows.append(("4x SR streaming inference, 134x320 LR, fp32",
                 f"{fps32:.1f} frames/s", ""))
    fps_b4 = _fps_infer_batch(4, device=device)
    rows.append(("4x SR batched serving, 4 concurrent streams, bf16",
                 f"{fps_b4:.1f} frames/s aggregate",
                 f"{fps_b4 / fps16:.2f}x one stream's throughput"))
    for scale, deg in ((2, "BD"), (4, "BI"), (2, "BI")):
        fps = _fps_infer("bfloat16", scale=scale, degradation=deg,
                         device=device)
        note = ("one upsample stage" if scale == 2 else
                "bilinear residual path")
        rows.append((f"{scale}x SR streaming inference, 134x320 LR, bf16, "
                     f"{deg}", f"{fps:.1f} frames/s",
                     f"family matrix: {note}"))
    t_fr = _train_iter("frvsr", mixed_precision=True, device=device)
    rows.append(("FRVSR train step (batch 4 x 10 frames x 128^2 GT, "
                 "mixed precision: the default)",
                 f"{t_fr * 1000:.1f} ms/iter = {4 / t_fr:.1f} clips/s",
                 "the reference's full 2-GPU geometry on one card"))
    t_mx, flops_mx = _train_iter("tecogan", mixed_precision=True,
                                 report_mfu=True, device=device)
    name = card_line(device).split(",")[0]
    peak = BF16_PEAK_FLOPS.get(name)
    mfu = (f"{100 * flops_mx / peak:.1f}% of the {peak / 1e12:.0f} TF/s "
           f"bf16 peak" if peak else "MFU n/a (card not in the table)")
    rows.append(("TecoGAN GAN step (same geometry, all losses, mixed "
                 "precision: the default)",
                 f"{t_mx * 1000:.1f} ms/iter = {4 / t_mx:.1f} clips/s",
                 f"{flops_mx / 1e12:.1f} TF/s counted = {mfu}"))
    for scale, deg in ((2, "BD"), (4, "BI"), (2, "BI")):
        t_f = _train_iter("tecogan", mixed_precision=True, scale=scale,
                          degradation=deg, device=device)
        rows.append((f"TecoGAN GAN step, {scale}x {deg} (batch 4 x 10 "
                     "frames x 128^2 GT, mixed precision)",
                     f"{t_f * 1000:.1f} ms/iter = {4 / t_f:.1f} clips/s",
                     "family matrix"))
    t_nr = _train_iter("tecogan", mixed_precision=True, remat=False,
                       device=device)
    rows.append(("TecoGAN GAN step, generator.remat: false",
                 f"{t_nr * 1000:.1f} ms/iter = {4 / t_nr:.1f} clips/s", ""))
    t_tg = _train_iter("tecogan", device=device)
    rows.append(("TecoGAN GAN step, mixed_precision: false (fp32)",
                 f"{t_tg * 1000:.0f} ms/iter = {4 / t_tg:.1f} clips/s", ""))
    with tempfile.TemporaryDirectory() as d:
        rate = _loader_rate(d)
    rows.append(("host input pipeline (records store, threaded loader, "
                 "native clip assembler where g++ builds it)",
                 f"{rate:.0f} clips/s", ""))
    # a data-parallel host assembling a global batch of 32 clips, its
    # threads fitted to the cores it has
    ncpu = os.cpu_count() or 1
    nw = max(1, min(8, ncpu))
    th = max(1, min(8, ncpu // nw))
    with tempfile.TemporaryDirectory() as d:
        rate32 = _loader_rate(d, batch_size=32, num_workers=nw, threads=th)
    t_batch_ms = 1000 * 32 / rate32
    rows.append((f"host input pipeline at a global batch of 32 ({nw} "
                 f"workers x {th} assembler threads on a {ncpu}-core host)",
                 f"{rate32:.0f} clips/s = {t_batch_ms:.1f} ms/batch",
                 f"vs {t_mx * 1000:.0f} ms GAN step at batch 4: "
                 + ("keeps ahead of 8 cards" if t_batch_ms < t_mx * 1000
                    else "needs more host cores for 8 cards")))
    return rows


def write_table(rows, card):
    """``rows`` as ``BENCHMARKS_TORCH.md``, keeping what stands below the
    manual evidence marker."""
    import torch

    path = _TABLE_PATH
    lines = [
        f"# BENCHMARKS_TORCH — the PyTorch/CUDA port, measured on {card}",
        "",
        "Generated by `python -m tecogan_tpu_torch.tools.bench_suite` "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda}).",
        "",
        "Protocols: streaming-inference rows run the 64-frame clip as one "
        "chunk (chunk=64), one warm-up, min of 4, a checksum read back. "
        "Train-step rows enqueue 4 steps a sync (the real loop reads its "
        "logs every log_freq iterations), min of 3 rounds after a warm-up "
        "step. Weights and data are random, from fixed seeds.",
        "",
        "| Benchmark | Result | Notes |",
        "|---|---|---|",
    ]
    lines += [f"| {name} | {result} | {note} |" for name, result, note
              in rows]
    manual = _MANUAL_MARKER + "\n"
    if osp.exists(path):
        with open(path) as f:
            prev = f.read()
        if _MANUAL_MARKER in prev:
            manual = prev[prev.index(_MANUAL_MARKER):]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n\n" + manual)
    print("\n".join(lines))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.bench_suite")
    ap.add_argument("--check", action="store_true",
                    help="perf canary: measure the headline numbers against "
                         "tools/perf_canary.json's bands; exit 1 on a "
                         "regression (the table is not rewritten)")
    ap.add_argument("--update", action="store_true",
                    help="with --check: write the measured values as the "
                         "new baselines, only if the check passed")
    ap.add_argument("--headline", action="store_true",
                    help="print the canary's three metrics as one JSON "
                         "line and exit")
    args = ap.parse_args(argv)
    if args.update and not args.check:
        ap.error("--update only applies to the canary: pass --check "
                 "--update")
    if args.headline:
        print(f"card: {card_line(device)}")
        print(json.dumps(measure_headline(device)))
        return 0
    if args.check:
        return 0 if check_canary(update=args.update, device=device) else 1
    write_table(_rows(device), card_line(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
