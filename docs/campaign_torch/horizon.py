"""Helpers for running the synthetic campaign on a card machine that keeps
no files between runs, and for summarising the run (see README.md)::

    python3 docs/campaign_torch/horizon.py until SECS CMD...
    python3 docs/campaign_torch/horizon.py stop_at N [--ckpt_freq K] \\
        [--device D] -- ARGS...
    python3 docs/campaign_torch/horizon.py tpu_default_data -- ARGS...
    python3 docs/campaign_torch/horizon.py carry WORKDIR OUT [--state NAME]
    python3 docs/campaign_torch/horizon.py restore OUT WORKDIR CKPTS
    python3 docs/campaign_torch/horizon.py g_from_state STATE G_NPZ [--nb 10]
    python3 docs/campaign_torch/horizon.py ms TRAIN_LOG VAL_EVERY
    python3 docs/campaign_torch/horizon.py plot WORKDIR OUT_DIR
    JAX_PLATFORMS=cpu python3 docs/campaign_torch/horizon.py bicubic_cpu WD
    python3 docs/campaign_torch/horizon.py dtype_cpu WD G_NPZ
    python3 docs/campaign_torch/horizon.py score WD G_NPZ OUT_JSON \
        [--degradation BD|BI] [--scale 4|2] [--device cuda|cpu]
    JAX_PLATFORMS=cpu python3 docs/campaign_torch/horizon.py bicubic_tpu WD
    python3 docs/campaign_torch/horizon.py summarize DOCS_DIR
    python3 docs/campaign_torch/horizon.py score_points WD CKPT_DIR OUT_JSON \
        [--device cpu|cuda] [--own N ...]
    python3 docs/campaign_torch/horizon.py heldout_tpu WD FRVSR_G TECOGAN_G \
        OUT_JSON [--device cpu|cuda]
    python3 docs/campaign_torch/horizon.py full_summary DOCS_DIR

until   (superseded by stop_at, which stops only at a validated
        checkpoint: until can stop a run inside a step, and the
        iterations since its last state are lost) runs CMD; after SECS
        it sends SIGINT to each
        ``tecogan_tpu_torch.main`` process among CMD and the processes
        below it (the training CLI: it saves its state where it stands
        between steps, or leaves the newest periodic
        ``state_iter{N}.pth``) and waits for CMD to end. Started from a
        foreground process, so that SIGINT is not ignored as it is in a
        shell's background jobs.
stop_at runs ``tecogan_tpu_torch.tools.run_synth_campaign ARGS`` in this
        process and stops its training CLI (SIGINT) once the run's
        validation JSON holds ``G_iter{N}`` (N 0: no fixed stop), or,
        with ``--budget SECS``, at the first validated checkpoint after
        which one more validation interval would not fit in SECS; never
        at the run's last iteration, where the CLI ends by itself. A
        stop at a validated checkpoint leaves ``state_iter{N}.pth`` when
        the save cadence is the validation's. ``--ckpt_freq K`` sets only
        the save cadence of the run's train.yml (``logger.ckpt_freq``),
        so that ``G_iter{N}.npz`` is written; the cadence does not change
        training.
tpu_default_data  runs ``tecogan_tpu_torch.tools.run_synth_campaign
        ARGS`` in this process with its data stage under
        ``TpuDefaultPrecision``: BI's LR frames (training records and
        held-out PNGs) made with the TPU's products, as the JAX script's
        data stage made them on its chip.
carry   copies a workdir's logs, ymls, metric JSONs and CSVs, and the
        newest ``state_iter{N}.pth`` of each run whose path holds NAME
        (all runs without --state, none with --state none), into OUT;
        with ``--ckpts NAME`` also every ``G_iter{N}.npz`` of the runs
        whose path holds NAME but the one the carried state holds; the
        corpus, result PNGs and other checkpoints stay behind.
restore puts what ``carry`` brought back into OUT where the next call
        and the scoring read it: each ``G_iter{N}.npz`` into
        CKPTS/<run>/, the rest into WORKDIR; each state's generator as
        CKPTS/<run>/G_iter{N}.npz too.
g_from_state  writes ``G_iter{N}.npz`` (the JAX layout ``VSRModel.save``
        writes) from a state file's generator weights.
ms      ms per iteration from the log lines' timestamps, over each window
        of 100 iterations that holds no validation: count, min, median,
        max.
plot    plots each run's train.log and validation JSON with
        ``scripts/monitor_training.py`` into OUT_DIR as
        ``<prefix><run>_monitor.png``.
bicubic_cpu  makes the held-out set from the seed in WD (the data stage,
        on the CPU), computes the bicubic baseline there with the port
        (float32 on the CPU) and with the JAX script
        (``scripts/run_synth_campaign.py``, jax on the CPU), and scores
        both with the port's official harness: the baseline's row without
        the card's or the TPU's arithmetic.
dtype_cpu  scores a generator checkpoint on WD's held-out set (made by
        bicubic_cpu) through test mode on the CPU, once with
        ``compute_dtype: float32`` and once with ``bfloat16``: what
        inference precision alone moves in the campaign's metrics.
score   scores ``G_NPZ`` on WD's held-out set as the training run's
        validation does (the CLI's test mode with the campaign's test
        block and metrics, in this process), twice: in fp32 (TF32 off,
        as the validation runs) and under ``TpuDefaultPrecision``; for
        BI a third time under the mode on held-out LR frames made under
        it too, as the JAX script's data stage made them on the TPU;
        writes the readings and the ops the mode met in one FRNet
        forward to OUT_JSON.
bicubic_tpu  makes the held-out set from the seed in WD on the CPU and
        computes the port's bicubic baseline there under
        ``TpuDefaultPrecision``, scored by the official harness: the
        baseline's row with the TPU's DEFAULT-precision products.

summarize  reads each leg's ``<leg>_score.json`` in DOCS_DIR (``score``'s
        output; a ``<leg>_score_cpu.json`` adds its BI reading with the
        LR frames under the scorer) and its ``<leg>_train.log``, and
        writes
        ``legs_summary.json`` (each leg's own reading, its scorer
        reading (for BI also with the LR frames under the scorer) and the
        JAX run's at the same checkpoint, from
        ``docs/campaign/<leg>_validation.json``, the difference and
        whether it is inside 0.5 dB, 1e-3 SSIM and 10% tOF, the leg's
        ms/iteration, and whether it is its recipe's comparison of
        record: BI's is ``frvsr_bi_tpu_lr``, whose LR frames were made as
        the JAX leg's were) and ``twin_summary.json`` (the two precision
        twins and their bf16 - fp32 differences).

score_points  scores every ``G_iter{N}.npz`` of CKPT_DIR under the scorer
        on WD's held-out set (``score``'s second reading; ``--own N``
        also reads those checkpoints in fp32), one point after another
        into OUT_JSON, keeping the points it already holds.
heldout_tpu  the eval's FRVSR and TecoGAN rows on WD's held-out set,
        test mode plain and under the scorer, each scored by the official
        harness (the JAX rows came from TPU inference with
        DEFAULT-precision products).
full_summary  reads the full schedule's artifacts in DOCS_DIR
        (``full_<half>_{train.log,validation.json,scores.json}``,
        ``full_eval_summary.json``, ``full_heldout_tpu.json``) and writes
        ``full_summary.json``: every JAX validation point and held-out
        row with its own, scorer, JAX reading, scorer - JAX and the band
        verdict, and from the logs ms/iteration, ``lr_G`` at the
        milestones and after each resume, D's updates, kernel launches.

``TpuDefaultPrecision`` is the arithmetic of the JAX package on its TPU
for the one thing it left at XLA's default: the precision of float32
products. The package sets no ``precision=`` anywhere, so on the TPU
every float32 convolution, dot and einsum ran as one bf16 pass of the
MXU: both operands rounded to bf16 (to nearest, ties to even), the
products summed in float32. The mode rounds both operands of
``conv2d``, ``conv_transpose2d``, ``linear``, ``matmul`` (``@``),
``mm``, ``bmm`` and ``einsum`` to bf16 and computes the product in
float32 with TF32 off; a bias is added unrounded, as XLA adds it after
the product. Everything else passes unchanged: the bilinear warps (the
Pallas kernels computed in float32 on the VPU), the elementwise ops and
the reductions. What it cannot emulate: the MXU 0/1-selector relayouts
of the JAX generator (``tecogan_tpu/models/networks/frnet.py:248-343``),
matrix products that move data between layouts and so also rounded the
data they moved to bf16 on the TPU; the port moves it with plain copies.
"""

import argparse
import collections
import contextlib
import datetime
import json
import os
import os.path as osp
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
LINE = re.compile(r"(\S+ \S+) \[INFO\]: \[epoch: \d+ \| iter: (\d+)")


def _descendants(root):
    """root's pid and those of every process below it."""
    children = {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(pid))
    out, todo = [], [root]
    while todo:
        pid = todo.pop()
        out.append(pid)
        todo.extend(children.get(pid, []))
    return out


def _bf16(x):
    """A float32 tensor rounded to bf16 and back; anything else as it
    is."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _op_name(func):
    return getattr(func, "__name__", None) or repr(func)


_TWO_OPERANDS = {
    torch.conv2d: "conv2d", torch.conv_transpose2d: "conv_transpose2d",
    torch.nn.functional.linear: "linear", torch.matmul: "matmul",
    torch.Tensor.matmul: "matmul", torch.Tensor.__matmul__: "matmul",
    torch.Tensor.__rmatmul__: "matmul", torch.mm: "mm",
    torch.Tensor.mm: "mm", torch.bmm: "bmm", torch.Tensor.bmm: "bmm"}
# the operands by keyword, where a caller names them
_OPERAND_KEYS = ("input", "weight", "other", "mat2")


class TpuDefaultPrecision(TorchFunctionMode):
    """float32 products as XLA's DEFAULT precision computed them on the
    TPU: both operands rounded to bf16, the product in float32 (TF32
    off). ``rounded`` and ``passed`` count the ops the mode met, by name.
    See the module's docstring for what it covers and what not."""

    def __init__(self):
        super().__init__()
        self.rounded = collections.Counter()
        self.passed = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from tecogan_tpu_torch.nn import no_tf32

        kwargs = dict(kwargs or {})
        name = _TWO_OPERANDS.get(func)
        if name is None and func is torch.einsum:
            name = "einsum"
        if name is None:
            self.passed[_op_name(func)] += 1
            return func(*args, **kwargs)
        self.rounded[name] += 1
        if name == "einsum":
            eq, *ops = args
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = ops[0]
            args = (eq, *map(_bf16, ops))
        else:
            args = (*map(_bf16, args[:2]), *args[2:])
            kwargs.update({k: _bf16(kwargs[k]) for k in _OPERAND_KEYS
                           if k in kwargs})
        with no_tf32():
            return func(*args, **kwargs)


def until(secs, cmd):
    proc = subprocess.Popen(cmd)
    try:
        proc.wait(timeout=secs)
    except subprocess.TimeoutExpired:
        for pid in _descendants(proc.pid):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    args = f.read().split(b"\0")
            except OSError:
                continue
            if b"tecogan_tpu_torch.main" in args:
                print(f"SIGINT -> {pid}", flush=True)
                os.kill(pid, signal.SIGINT)
        proc.wait()
    return proc.returncode


def tpu_default_data(args):
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    stage_data = port.stage_data

    def under_mode(*a, **kw):
        with TpuDefaultPrecision():
            return stage_data(*a, **kw)

    port.stage_data = under_mode
    port.main(args)


def _workdir_arg(args):
    """The ``--workdir`` among the campaign's ARGS."""
    for i, a in enumerate(args):
        if a == "--workdir":
            return args[i + 1]
        if a.startswith("--workdir="):
            return a.split("=", 1)[1]
    raise SystemExit("stop_at: name the run's --workdir")


# stop_at's budget: the next validation interval counts at this many times
# the last one's length
MARGIN = 1.25


def stop_at(n, args, ckpt_freq=None, device=None, poll_s=5.0,
            budget=None):
    """Run the campaign's ARGS in this process; SIGINT its training CLI
    once a validation JSON under the workdir holds ``G_iter{n}`` (``n``
    0: no fixed stop), or, with ``budget`` seconds, at the first validated
    checkpoint after which one more validation interval, at ``MARGIN``
    times the last one's length, would end past the budget. Never at or past
    the run's ``total_iter``: there the CLI ends by itself (its kernel
    launch line and exit code intact)."""
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    wd, stopped = _workdir_arg(args), threading.Event()
    # the run the stage trains: another run's validations (FRVSR's, where
    # TecoGAN trains) are not this one's
    run = {"frvsr": "FRVSR_", "tecogan": "TecoGAN_"}.get(args[0], "")
    total = {}
    base_opt = port._base_opt

    def with_cadence(*a, **kw):
        opt = base_opt(*a, **kw)
        total["iter"] = opt["train"]["total_iter"]
        if ckpt_freq:
            opt["logger"]["ckpt_freq"] = ckpt_freq
        return opt

    port._base_opt = with_cadence

    def validated():
        """The iterations a validation JSON under the workdir holds."""
        out = set()
        for d in os.listdir(wd) if osp.isdir(wd) else ():
            if not d.startswith(run):
                continue
            js = osp.join(wd, d, "test", "metrics", "SynthHeldout_avg.json")
            try:
                with open(js) as f:
                    out |= {int(k[len("G_iter"):]) for k in json.load(f)
                            if re.fullmatch(r"G_iter\d+", k)}
            except (OSError, ValueError):
                continue
        return out

    def interrupt(key):
        for pid in _descendants(os.getpid()):
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().split(b"\0")
            except OSError:
                continue
            if b"tecogan_tpu_torch.main" in cmd:
                print(f"{key} validated: SIGINT -> {pid}", flush=True)
                os.kill(pid, signal.SIGINT)

    def watch():
        seen, t_last = validated(), time.monotonic()
        t0 = t_last
        while not stopped.is_set():
            new = validated() - seen
            if new:
                k, now = max(new), time.monotonic()
                seen |= new
                interval, t_last = now - t_last, now
                over = budget and now - t0 + MARGIN * interval > budget
                if k < total.get("iter", float("inf")) and (
                        n in new or over):
                    if over and n not in new:
                        print(f"budget: {now - t0:.0f} s used, the next "
                              f"interval needs about {interval:.0f} s",
                              flush=True)
                    interrupt(f"G_iter{k}")
                    stopped.set()
                    return
            time.sleep(poll_s)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        port.main(args, device=device)
    except RuntimeError:
        if not stopped.is_set():
            raise
    finally:
        stopped.set()
        port._base_opt = base_opt
    last = max(validated(), default=0)
    print(f"stopped after G_iter{last}" if n and last >= n
          else f"last validated G_iter{last}")
    return 0 if not n or last >= n or last >= total.get("iter", 0) else 1


def carry(workdir, out, state=None, ckpts=None):
    """``ckpts`` NAME also copies the ``G_iter{N}.npz`` of each run whose
    path holds NAME, but for the one whose weights the carried state
    holds (``g_from_state`` remakes it)."""
    for root, _, files in os.walk(workdir):
        rel = osp.relpath(root, workdir)
        if rel.split(os.sep)[0] == "data" or "results" in rel.split(os.sep):
            continue
        keep = [f for f in files
                if f.endswith((".log", ".yml", ".json", ".csv", ".txt"))]
        states = sorted((f for f in files
                         if re.fullmatch(r"state_iter\d+\.pth", f)),
                        key=lambda f: int(re.findall(r"\d+", f)[0]))
        held = None
        if states and (state is None or state in rel):
            keep.append(states[-1])
            held = f"G_iter{re.findall(r'[0-9]+', states[-1])[0]}.npz"
        if ckpts is not None and ckpts in rel:
            keep += sorted(f for f in files
                           if re.fullmatch(r"G_iter\d+\.npz", f)
                           and f != held)
        for f in keep:
            os.makedirs(osp.join(out, rel), exist_ok=True)
            shutil.copy2(osp.join(root, f), osp.join(out, rel, f))
            print(f"carried {osp.join(rel, f)}")


def restore(out, workdir, ckpts, nb=10, scale=4):
    """Put what ``carry`` brought back from a card call (OUT) where the
    next call and the scoring read it: every ``G_iter{N}.npz`` into
    CKPTS/<run>/, the rest into WORKDIR at its relative path; for each
    state file, its generator as CKPTS/<run>/G_iter{N}.npz (the one carry
    leaves out)."""
    for root, _, files in os.walk(out):
        rel = osp.relpath(root, out)
        run = rel.split(os.sep)[0]
        if rel == ".":
            continue  # the call's own files (card.txt, scores)
        for f in files:
            if re.fullmatch(r"G_iter\d+\.npz", f):
                dst = osp.join(ckpts, run, f)
            else:
                dst = osp.join(workdir, rel, f)
            os.makedirs(osp.dirname(dst), exist_ok=True)
            shutil.copy2(osp.join(root, f), dst)
            if re.fullmatch(r"state_iter\d+\.pth", f):
                g = osp.join(ckpts, run, f"G_iter{_iter_of(f)}.npz")
                if not osp.exists(g):
                    g_from_state(osp.join(root, f), g, nb, scale)
            print(f"restored {dst}")


def g_from_state(state, out, nb=10, scale=4):
    import torch

    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.models.convert import jax_from_state_dict
    from tecogan_tpu_torch.utils.ckpt import save_pytree

    saved = torch.load(state, weights_only=True, map_location="cpu")
    save_pytree(jax_from_state_dict(saved["g"], nb, scale), out)


def ms(log, val_every):
    pts = []
    with open(log) as f:
        for ln in f:
            m = LINE.match(ln)
            if m:
                t = datetime.datetime.strptime(m.group(1),
                                               "%Y-%m-%d %H:%M:%S,%f")
                pts.append((int(m.group(2)), t))
    out = [(t1 - t0).total_seconds() * 1000 / (i1 - i0)
           for (i0, t0), (i1, t1) in zip(pts, pts[1:])
           if i1 - i0 == 100 and i0 // val_every == (i1 - 1) // val_every
           and i0 % val_every]
    if not out:
        raise SystemExit(f"{log}: no window of 100 iterations without a "
                         f"validation")
    return len(out), min(out), statistics.median(out), max(out)


def plot(workdir, out_dir, prefix=""):
    for run in sorted(os.listdir(workdir)):
        log = osp.join(workdir, run, "train.log")
        js = osp.join(workdir, run, "test", "metrics", "SynthHeldout_avg.json")
        if not osp.exists(log):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            exp = osp.join(tmp, "experiments_BD", "M", "E")
            os.makedirs(osp.join(exp, "train"))
            os.makedirs(osp.join(exp, "test", "metrics"))
            shutil.copy(log, osp.join(exp, "train", "train.log"))
            if osp.exists(js):
                shutil.copy(js, osp.join(exp, "test", "metrics",
                                         "SynthHeldout_avg.json"))
            subprocess.run([sys.executable,
                            osp.join(REPO, "scripts", "monitor_training.py"),
                            "-m", "M", "-d", "BD", "-e", "E", "--testset",
                            "SynthHeldout"], cwd=tmp, check=True)
            name = run.split("_")[0].lower()
            shutil.copy(osp.join(exp, "monitor.png"),
                        osp.join(out_dir, f"{prefix}{name}_monitor.png"))


def bicubic_cpu(wd):
    import importlib.util

    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    spec = importlib.util.spec_from_file_location(
        "run_synth_campaign_jax",
        osp.join(REPO, "scripts", "run_synth_campaign.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    port.stage_data(wd, n_train=0, device="cpu")
    rows = {}
    for tag, fn in (("jax_cpu", jax_script._bicubic_baseline),
                    ("port_cpu", lambda w: port._bicubic_baseline(
                        w, device="cpu"))):
        root = osp.join(wd, "eval", "bicubic")
        if osp.exists(root):
            shutil.rmtree(root)
        fn(wd)
        os.rename(root, osp.join(wd, "eval", f"bicubic_{tag}"))
        rows[tag] = port._official_metrics(
            wd, tag, osp.join(wd, "eval", f"bicubic_{tag}"), "cpu")
    print(rows)


def dtype_cpu(wd, ckpt):
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    run_cli, rows = port._run_cli, {}
    for dt in ("float32", "bfloat16"):
        def with_dtype(exp, opt, mode, device=None, _dt=dt):
            opt["model"]["generator"]["compute_dtype"] = _dt
            run_cli(exp, opt, mode, device)

        port._run_cli = with_dtype
        try:
            res = port._test_model(wd, f"cpu_{dt}", osp.abspath(ckpt),
                                   device="cpu")
        finally:
            port._run_cli = run_cli
        rows[dt] = port._official_metrics(wd, f"cpu_{dt}", res, "cpu")
    print(rows)


def _in_process_cli(mode=None, save_res=False):
    """A stand-in for the campaign's ``_run_cli``: the port's CLI in this
    process (under ``mode`` if given), result PNGs written only with
    ``save_res``."""
    from tecogan_tpu_torch import main as cli
    from tecogan_tpu_torch.tools import run_synth_campaign as port
    from tecogan_tpu_torch.utils.yaml_subset import safe_dump

    def run(exp_dir, opt, run_mode, device=None):
        opt["test"]["save_res"] = save_res
        os.makedirs(exp_dir, exist_ok=True)
        yml = osp.join(exp_dir, f"{run_mode}.yml")
        with open(yml, "w") as f:
            f.write(safe_dump(port._block_yaml(opt)))
        argv = ["--exp_dir", exp_dir, "--mode", run_mode, "--opt", yml,
                "--gpu_ids", port._gpu_ids(device)]
        if mode is None:
            cli.main(argv)
        else:
            with mode:
                cli.main(argv)

    return run


def _score_once(wd, ckpt, name, degradation, device, mode=None, nf=64,
                nb=10):
    """One validation of ``ckpt`` in this process (test mode, the
    campaign's test block and metrics, no PNGs), under ``mode`` if given:
    {PSNR, SSIM, tOF} as the validation JSON holds them."""
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    run_cli, port._run_cli = port._run_cli, _in_process_cli(mode)
    try:
        port._test_model(wd, name, osp.abspath(ckpt), nf=nf, nb=nb,
                         degradation=degradation, device=device)
    finally:
        port._run_cli = run_cli
    with open(osp.join(wd, "eval", name, "metrics",
                       "SynthHeldout_avg.json")) as f:
        return json.load(f)[osp.splitext(osp.basename(ckpt))[0]]


def _forward_ops(device):
    """The ops ``TpuDefaultPrecision`` meets in one FRNet forward (FNet,
    the HR flow, the warp, SRNet) at nf=64, nb=10: {rounded, passed}."""
    from tecogan_tpu_torch.models.networks import FRNet, FRNetConfig

    net = FRNet.random(FRNetConfig(nf=64, nb=10),
                       torch.Generator().manual_seed(0)).to(device)
    lr = torch.rand((2, 1, 3, 32, 32), generator=torch.Generator()
                    .manual_seed(1)).to(device)
    hr = torch.zeros((1, 3, 128, 128), device=device)
    mode = TpuDefaultPrecision()
    with torch.no_grad(), mode:
        net.step(lr[0], lr[1], hr)
    return {"rounded": dict(mode.rounded), "passed": dict(mode.passed)}


def _tpu_default_lr_workdir(wd, device):
    """A workdir beside ``wd``'s eval whose held-out set is ``wd``'s GT and
    BI LR frames made from it under ``TpuDefaultPrecision``, as the JAX
    script's data stage made them on the TPU; returns its path."""
    from tecogan_tpu_torch.tools import run_synth_campaign as port
    from tecogan_tpu_torch.utils.png import read_image

    out = osp.join(wd, "eval", "tpu_default_lr")
    gt_dir = osp.join(wd, "data", "test_GT")
    os.makedirs(osp.join(out, "data"), exist_ok=True)
    if not osp.exists(osp.join(out, "data", "test_GT")):
        os.symlink(osp.abspath(gt_dir), osp.join(out, "data", "test_GT"))
    for seq in sorted(os.listdir(gt_dir)):
        lr_dir = osp.join(out, "data", "test_LR", seq)
        if osp.exists(lr_dir):
            continue
        clip = np.stack([read_image(osp.join(gt_dir, seq, fn))
                         for fn in sorted(os.listdir(osp.join(gt_dir, seq)))])
        with TpuDefaultPrecision():
            lr = port._bi_lr(clip, device=device)
        port._write_frames(lr_dir, lr)
    return out


def score(wd, ckpt, out, degradation="BD", scale=4, device=None, nf=64,
          nb=10):
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    port.GEOM["scale"] = scale
    tag = osp.splitext(osp.basename(ckpt))[0]
    t0 = time.perf_counter()
    own = _score_once(wd, ckpt, f"score_fp32_{tag}", degradation, device,
                      nf=nf, nb=nb)
    t1 = time.perf_counter()
    mode = TpuDefaultPrecision()
    emulated = _score_once(wd, ckpt, f"score_tpu_default_{tag}",
                           degradation, device, mode, nf=nf, nb=nb)
    t2 = time.perf_counter()
    lr_too = {}
    if degradation == "BI":
        # the JAX BI leg's held-out LR frames came from the TPU's products
        lr_too["tpu_default_lr_too"] = _score_once(
            _tpu_default_lr_workdir(wd, device), ckpt,
            f"score_tpu_default_lr_{tag}", degradation, device,
            TpuDefaultPrecision(), nf=nf, nb=nb)
    res = {"checkpoint": tag, "degradation": degradation, "scale": scale,
           "device": str(device or "cuda"),
           "fp32": own, "tpu_default": emulated, **lr_too,
           "seconds": {"fp32": round(t1 - t0, 1),
                       "tpu_default": round(t2 - t1, 1)},
           "ops_in_scoring": {"rounded": dict(mode.rounded)},
           "ops_in_one_frnet_forward": _forward_ops(device or "cuda")}
    with open(out, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res, indent=2))


def bicubic_tpu(wd):
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    port.stage_data(wd, n_train=0, device="cpu")
    rows = {}
    for tag, mode in (("port_cpu", None),
                      ("port_cpu_tpu_default", TpuDefaultPrecision())):
        root = osp.join(wd, "eval", "bicubic")
        if osp.exists(root):
            shutil.rmtree(root)
        if mode is None:
            port._bicubic_baseline(wd, device="cpu")
        else:
            with mode:
                port._bicubic_baseline(wd, device="cpu")
            rows["rounded"] = dict(mode.rounded)
        os.rename(root, osp.join(wd, "eval", f"bicubic_{tag}"))
        rows[tag] = port._official_metrics(
            wd, tag, osp.join(wd, "eval", f"bicubic_{tag}"), "cpu")
    print(json.dumps(rows))


def _iter_of(name):
    return int(re.findall(r"\d+", osp.basename(name))[0])


def score_points(wd, ckpt_dir, out, device="cpu", own=(), nf=64, nb=10):
    """Score every ``G_iter{N}.npz`` in ``ckpt_dir`` under
    ``TpuDefaultPrecision`` on WD's held-out set (made there from the seed
    if missing), as ``score`` does, and write {checkpoint: {"tpu_default":
    reading, "seconds": s}} to ``out`` after each point; points already in
    ``out`` are kept. The checkpoints in ``own`` are also read in fp32
    (the validation's own reading, here on ``device``)."""
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    if not osp.isdir(osp.join(wd, "data", "test_GT")):
        port.stage_data(wd, n_train=0, device=device)
    done = {}
    if osp.exists(out):
        with open(out) as f:
            done = json.load(f)
    ckpts = sorted((f for f in os.listdir(ckpt_dir)
                    if re.fullmatch(r"G_iter\d+\.npz", f)), key=_iter_of)
    for f in ckpts:
        tag, ckpt = f[:-len(".npz")], osp.join(ckpt_dir, f)
        row = done.get(tag, {})
        if "tpu_default" not in row:
            t0 = time.perf_counter()
            row["tpu_default"] = _score_once(
                wd, ckpt, f"score_tpu_default_{tag}", "BD", device,
                TpuDefaultPrecision(), nf=nf, nb=nb)
            row["seconds"] = round(time.perf_counter() - t0, 1)
        if _iter_of(f) in own and "fp32" not in row:
            row["fp32"] = _score_once(wd, ckpt, f"score_fp32_{tag}", "BD",
                                      device, nf=nf, nb=nb)
        done[tag] = row
        with open(out, "w") as fh:
            json.dump(dict(sorted(done.items(), key=lambda kv: _iter_of(
                kv[0]))), fh, indent=2)
        print(tag, json.dumps(row), flush=True)


def _harness(wd, tag, res_root, device):
    """``run_synth_campaign._official_metrics`` run in this process: the
    official harness on ``res_root`` against WD's held-out GT, its console
    summary parsed."""
    import io

    from tecogan_tpu_torch.official_metrics import metrics
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    out = osp.join(wd, "eval", f"official_{tag}")
    os.makedirs(out, exist_ok=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metrics.main(["--output", out, "--results", res_root, "--targets",
                      osp.join(wd, "data", "test_GT"), "--gpu_ids",
                      port._gpu_ids(device)])
    summary = {}
    for line in buf.getvalue().splitlines():
        m = port.METRIC_LINE_RE.match(line.strip())
        if m:
            summary[m.group(1)] = {"frames": int(m.group(2)),
                                   "frame_avg": float(m.group(3)),
                                   "folder_avg": float(m.group(4))}
    return summary


def heldout_tpu(wd, frvsr_ckpt, tecogan_ckpt, out, device="cpu", nf=64,
                nb=10):
    """The eval's FRVSR and TecoGAN rows on WD's held-out set (made there
    from the seed if missing), read twice: test mode as it runs (fp32,
    TF32 off) and test mode under ``TpuDefaultPrecision`` (the JAX rows
    came from TPU inference with DEFAULT-precision products, the BD
    degradation's included), each scored by the official harness (in this
    process; ``bicubic_tpu`` reads the baseline). Writes {row: harness
    summary} to ``out``."""
    sys.path.insert(0, REPO)
    from tecogan_tpu_torch.tools import run_synth_campaign as port

    if not osp.isdir(osp.join(wd, "data", "test_GT")):
        port.stage_data(wd, n_train=0, device=device)
    rows = {}
    for tag, mode in (("plain", None), ("tpu_default", TpuDefaultPrecision)):
        for name, ckpt in (("FRVSR_Synth_4xSR", frvsr_ckpt),
                           ("TecoGAN_Synth_4xSR", tecogan_ckpt)):
            run = f"{name}_{tag}"
            run_cli = port._run_cli
            port._run_cli = _in_process_cli(mode() if mode else None,
                                            save_res=True)
            try:
                res = port._test_model(wd, run, osp.abspath(ckpt), nf=nf,
                                       nb=nb, device=device)
            finally:
                port._run_cli = run_cli
            rows[run] = _harness(wd, run, res, device)
            print(run, json.dumps(rows[run]), flush=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)


LR_LINE = re.compile(r"(\S+ \S+) \[INFO\]: \[epoch: \d+ \| iter: (\d+) \| "
                     r"lr_G: ([\d.e+-]+)(?: \| lr_D: ([\d.e+-]+))?\] (.*)")


def read_log(log):
    """A train.log's iteration lines [{iter, lr_G, lr_D, losses...}] in
    order of appearance (a resumed span's lines after the resume), each
    resume as [the state's iteration, the first line's after it], and the
    kernel launch lines' counts."""
    lines, resumes, launches, pending = [], [], [], None
    with open(log) as f:
        for ln in f:
            if "Resumed training state from" in ln:
                pending = _iter_of(ln.rsplit("state_iter", 1)[1])
            elif "kernel launches: " in ln:
                launches.append(json.loads(ln.split("kernel launches: ")[1]))
            m = LR_LINE.match(ln)
            if not m:
                continue
            row = {"iter": int(m.group(2)), "lr_G": float(m.group(3))}
            if m.group(4):
                row["lr_D"] = float(m.group(4))
            for kv in m.group(5).split(", "):
                k, v = kv.split(": ")
                row[k] = float(v)
            lines.append(row)
            if pending is not None:
                resumes.append([pending, row["iter"]])
                pending = None
    return lines, resumes, launches


# the full schedule's halves: (validation cadence, total iterations, the
# JAX run's validation JSON in docs/campaign/)
FULL = {"frvsr": (5000, 40000, "frvsr_validation.json"),
        "tecogan": (2500, 15000, "tecogan_validation.json")}


def _lr_expected(half, it):
    if half == "tecogan":
        return 5e-5
    return 1e-4 * 0.5 ** sum(it >= m for m in (16000, 32000))


def full_summary(docs):
    """Reads the full run's artifacts in DOCS_DIR (``full_<half>_train.log``,
    ``full_<half>_validation.json``, ``full_<half>_scores.json`` from
    ``score_points``, ``full_eval_summary.json`` (the card's eval) and
    ``full_heldout_tpu.json`` from ``heldout_tpu``) and writes
    ``full_summary.json``: for every JAX validation point the run reached
    its own fp32 reading (the run's validation), the scorer's, the JAX
    run's, scorer - JAX and the band verdict (the JAX reading alone where
    the run stopped short); the held-out rows the same way against
    ``docs/campaign/summary.json`` (a verdict only at the JAX row's own
    checkpoint); and from the logs the ms/iteration, the learning rates
    at the milestones and after each resume, D's updates and the kernel
    launches."""
    out = {"band": BAND}
    for half, (every, _, jax_json) in FULL.items():
        with open(osp.join(docs, f"full_{half}_validation.json")) as f:
            own = {k: _floats(v) for k, v in json.load(f).items()}
        with open(osp.join(docs, f"full_{half}_scores.json")) as f:
            scores = json.load(f)
        with open(osp.join(REPO, "docs", "campaign", jax_json)) as f:
            jax = {k: _floats(v) for k, v in json.load(f).items()}
        points = {}
        for key in sorted(jax, key=_iter_of):
            row = {"jax": jax[key], "reached": key in own}
            if key in own:
                emu = _floats(scores[key]["tpu_default"])
                row.update({
                    "own_fp32": own[key], "tpu_default": emu,
                    "tpu_default_minus_jax": {
                        m: round(emu[m] - jax[key][m], 6) for m in METRICS},
                    "tpu_default_within_band_of_jax": _within(emu,
                                                              jax[key])})
                if "fp32" in scores[key]:
                    row["own_fp32_on_the_scoring_device"] = _floats(
                        scores[key]["fp32"])
            points[key] = row
        log = osp.join(docs, f"full_{half}_train.log")
        lines, resumes, launches = read_log(log)
        by_iter = {}
        for row in lines:
            by_iter.setdefault(row["iter"], row)
        marks = {r[1] for r in resumes} | {
            m + d for m in ((16000, 32000) if half == "frvsr" else ())
            for d in (-100, 0, 100)}
        n, lo, med, hi = ms(log, every)
        out[half] = {
            "points": points,
            "last_validated": max(own, key=_iter_of),
            "iterations_logged": [min(by_iter), max(by_iter)],
            "resumes": resumes,
            "lr_G": {str(i): {"lr_G": by_iter[i]["lr_G"],
                              "expected": _lr_expected(half, i)}
                     for i in sorted(marks) if i in by_iter},
            "lr_G_as_expected_on_every_line": all(
                abs(r["lr_G"] - _lr_expected(half, r["iter"])) <= 1e-12
                for r in lines),
            "ms_per_iteration": {"windows": n, "min": round(lo, 2),
                                 "median": round(med, 2),
                                 "max": round(hi, 2)},
            "kernel_launches_last_run": launches[-1] if launches else None}
        if half == "tecogan":
            for k in ("n_upd_D", "l_gan_D", "distance"):
                out[half][k] = {str(r["iter"]): r[k] for r in lines
                                if r["iter"] % 500 == 0 and k in r}
    with open(osp.join(REPO, "docs", "campaign", "summary.json")) as f:
        jax_rows = json.load(f)
    with open(osp.join(docs, "full_eval_summary.json")) as f:
        card_rows = json.load(f)
    with open(osp.join(docs, "full_heldout_tpu.json")) as f:
        tpu_rows = json.load(f)
    with open(osp.join(docs, "bicubic_tpu_default.json")) as f:
        bic = json.load(f)
    tpu_rows.update({"bicubic_plain": bic["port_cpu"],
                     "bicubic_tpu_default": bic["port_cpu_tpu_default"]})
    held = {}
    points = {"bicubic": (None, None),
              "FRVSR_Synth_4xSR": (out["frvsr"]["last_validated"],
                                   "G_iter40000"),
              "TecoGAN_Synth_4xSR": (out["tecogan"]["last_validated"],
                                     "G_iter15000")}
    for name, (ckpt, jax_ckpt) in points.items():
        jrow = {m: jax_rows[name][m]["frame_avg"] for m in METRICS}
        row = {"checkpoint": ckpt, "jax_checkpoint": jax_ckpt, "jax": jrow,
               "own_card": {m: card_rows[name][m]["frame_avg"]
                            for m in METRICS}}
        for tag in ("plain", "tpu_default"):
            got = {m: tpu_rows[f"{name}_{tag}"][m]["frame_avg"]
                   for m in METRICS}
            row[f"{tag}_cpu"] = got
            row[f"{tag}_cpu_minus_jax"] = {m: round(got[m] - jrow[m], 6)
                                           for m in METRICS}
        # a verdict only where the row is the JAX row's own checkpoint
        row["tpu_default_within_band_of_jax"] = (
            _within(row["tpu_default_cpu"], jrow) if ckpt == jax_ckpt
            else None)
        held[name] = row
    out["heldout"] = held
    with open(osp.join(docs, "full_summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


# leg: (the JAX run's validation JSON in docs/campaign/, the validation
# cadence of the leg's recipe)
LEGS = {"twin_bf16": ("twin_bf16_validation.json", 500),
        "twin_fp32": ("twin_fp32_validation.json", 500),
        "frvsr_bi": ("frvsr_bi_validation.json", 5000),
        "frvsr_2x": ("frvsr_2x_validation.json", 5000),
        # BI trained and scored on LR frames made under the scorer
        "frvsr_bi_tpu_lr": ("frvsr_bi_validation.json", 5000)}
# a leg whose comparison with the JAX leg another leg took over: BI's is
# (c'), trained and scored on LR frames made as the JAX leg's were
SUPERSEDED = {"frvsr_bi": "frvsr_bi_tpu_lr"}
METRICS = ("PSNR", "SSIM", "tOF")
# the band a leg's scorer reading is held to around the JAX reading
BAND = {"PSNR": 0.5, "SSIM": 1e-3, "tOF": 0.10}


def _floats(reading):
    return {m: float(reading[m]) for m in METRICS}


def _within(got, jax):
    return (abs(got["PSNR"] - jax["PSNR"]) <= BAND["PSNR"]
            and abs(got["SSIM"] - jax["SSIM"]) <= BAND["SSIM"]
            and abs(got["tOF"] - jax["tOF"]) <= BAND["tOF"] * jax["tOF"])


def summarize(docs):
    legs = {}
    for leg, (jax_json, val_every) in LEGS.items():
        path = osp.join(docs, f"{leg}_score.json")
        if not osp.exists(path):
            continue
        with open(path) as f:
            sc = json.load(f)
        cpu = osp.join(docs, f"{leg}_score_cpu.json")
        if "tpu_default_lr_too" not in sc and osp.exists(cpu):
            # the reading with the LR frames under the scorer, on the CPU
            with open(cpu) as f:
                sc["tpu_default_lr_too"] = json.load(f)["tpu_default_lr_too"]
        with open(osp.join(REPO, "docs", "campaign", jax_json)) as f:
            jax = _floats(json.load(f)[sc["checkpoint"]])
        own, emu = _floats(sc["fp32"]), _floats(sc["tpu_default"])
        n, lo, med, hi = ms(osp.join(docs, f"{leg}_train.log"), val_every)
        legs[leg] = {
            "checkpoint": sc["checkpoint"], "own_fp32": own,
            "tpu_default": emu, "jax": jax,
            "tpu_default_minus_jax": {m: round(emu[m] - jax[m], 6)
                                      for m in METRICS},
            "own_minus_tpu_default": {m: round(own[m] - emu[m], 6)
                                      for m in METRICS},
            "tpu_default_within_band_of_jax": _within(emu, jax),
            "band": BAND,
            **({"tpu_default_lr_too": _floats(sc["tpu_default_lr_too"]),
                "tpu_default_lr_too_minus_jax": {
                    m: round(float(sc["tpu_default_lr_too"][m]) - jax[m], 6)
                    for m in METRICS},
                "tpu_default_lr_too_within_band_of_jax": _within(
                    _floats(sc["tpu_default_lr_too"]), jax)}
               if "tpu_default_lr_too" in sc else {}),
            "ms_per_iteration": {"windows": n, "min": round(lo, 2),
                                 "median": round(med, 2),
                                 "max": round(hi, 2)},
            "of_record": leg not in SUPERSEDED,
            **({"superseded_by": SUPERSEDED[leg]} if leg in SUPERSEDED
               else {})}
    with open(osp.join(docs, "legs_summary.json"), "w") as f:
        json.dump(legs, f, indent=2)
    if {"twin_bf16", "twin_fp32"} <= set(legs):
        b, p = legs["twin_bf16"], legs["twin_fp32"]
        twin = {"horizon": b["checkpoint"], **{
            key: {"bf16": b[key], "fp32": p[key],
                  "delta_bf16_minus_fp32": {
                      m: round(b[key][m] - p[key][m], 6) for m in METRICS}}
            for key in ("own_fp32", "tpu_default", "jax")},
            "ms_per_iteration_median": {
                "bf16": b["ms_per_iteration"]["median"],
                "fp32": p["ms_per_iteration"]["median"]}}
        with open(osp.join(docs, "twin_summary.json"), "w") as f:
            json.dump(twin, f, indent=2)
    print(json.dumps(legs, indent=2))


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("until")
    p.add_argument("secs", type=float)
    p.add_argument("command", nargs=argparse.REMAINDER)
    p = sub.add_parser("stop_at")
    p.add_argument("n", type=int)
    p.add_argument("--ckpt_freq", type=int, default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--budget", type=float, default=None)
    sub.add_parser("tpu_default_data")
    p = sub.add_parser("carry")
    p.add_argument("workdir")
    p.add_argument("out")
    p.add_argument("--state", default=None)
    p.add_argument("--ckpts", default=None)
    p = sub.add_parser("restore")
    p.add_argument("out")
    p.add_argument("workdir")
    p.add_argument("ckpts")
    p = sub.add_parser("g_from_state")
    p.add_argument("state")
    p.add_argument("out")
    p.add_argument("--nb", type=int, default=10)
    p.add_argument("--scale", type=int, default=4)
    p = sub.add_parser("ms")
    p.add_argument("log")
    p.add_argument("val_every", type=int)
    p = sub.add_parser("plot")
    p.add_argument("workdir")
    p.add_argument("out_dir")
    p.add_argument("--prefix", default="")
    p = sub.add_parser("bicubic_cpu")
    p.add_argument("workdir")
    p = sub.add_parser("dtype_cpu")
    p.add_argument("workdir")
    p.add_argument("ckpt")
    p = sub.add_parser("score")
    p.add_argument("workdir")
    p.add_argument("ckpt")
    p.add_argument("out")
    p.add_argument("--degradation", default="BD", choices=["BD", "BI"])
    p.add_argument("--scale", type=int, default=4, choices=[4, 2])
    p.add_argument("--device", default=None)
    p.add_argument("--nf", type=int, default=64)
    p.add_argument("--nb", type=int, default=10)
    p = sub.add_parser("bicubic_tpu")
    p.add_argument("workdir")
    p = sub.add_parser("summarize")
    p.add_argument("docs")
    p = sub.add_parser("score_points")
    p.add_argument("workdir")
    p.add_argument("ckpt_dir")
    p.add_argument("out")
    p.add_argument("--device", default="cpu")
    p.add_argument("--own", type=int, nargs="*", default=())
    p = sub.add_parser("heldout_tpu")
    p.add_argument("workdir")
    p.add_argument("frvsr_ckpt")
    p.add_argument("tecogan_ckpt")
    p.add_argument("out")
    p.add_argument("--device", default="cpu")
    p = sub.add_parser("full_summary")
    p.add_argument("docs")
    argv, rest = sys.argv[1:], []
    if argv[:1] in (["stop_at"], ["tpu_default_data"]) and "--" in argv:
        argv, rest = argv[:argv.index("--")], argv[argv.index("--") + 1:]
    a = ap.parse_args(argv)
    if a.cmd == "until":
        sys.exit(until(a.secs, a.command))
    if a.cmd == "stop_at":
        sys.exit(stop_at(a.n, rest, a.ckpt_freq, a.device,
                         budget=a.budget))
    if a.cmd == "tpu_default_data":
        sys.exit(tpu_default_data(rest))
    if a.cmd == "carry":
        carry(a.workdir, a.out, a.state, a.ckpts)
    elif a.cmd == "restore":
        restore(a.out, a.workdir, a.ckpts)
    elif a.cmd == "g_from_state":
        g_from_state(a.state, a.out, a.nb, a.scale)
    elif a.cmd == "ms":
        print("windows %d, ms/iteration min %.2f, median %.2f, max %.2f"
              % ms(a.log, a.val_every))
    elif a.cmd == "plot":
        plot(a.workdir, a.out_dir, a.prefix)
    elif a.cmd == "bicubic_cpu":
        bicubic_cpu(a.workdir)
    elif a.cmd == "dtype_cpu":
        dtype_cpu(a.workdir, a.ckpt)
    elif a.cmd == "score":
        score(a.workdir, a.ckpt, a.out, a.degradation, a.scale, a.device,
              a.nf, a.nb)
    elif a.cmd == "bicubic_tpu":
        bicubic_tpu(a.workdir)
    elif a.cmd == "score_points":
        score_points(a.workdir, a.ckpt_dir, a.out, a.device, a.own)
    elif a.cmd == "heldout_tpu":
        heldout_tpu(a.workdir, a.frvsr_ckpt, a.tecogan_ckpt, a.out, a.device)
    elif a.cmd == "full_summary":
        full_summary(a.docs)
    else:
        summarize(a.docs)


if __name__ == "__main__":
    main()
