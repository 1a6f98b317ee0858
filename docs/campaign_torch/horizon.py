"""Helpers for running the synthetic campaign on a card machine that keeps
no files between runs, and for summarising the run (see README.md)::

    python3 docs/campaign_torch/horizon.py until SECS CMD...
    python3 docs/campaign_torch/horizon.py carry WORKDIR OUT [--state NAME]
    python3 docs/campaign_torch/horizon.py g_from_state STATE G_NPZ [--nb 10]
    python3 docs/campaign_torch/horizon.py ms TRAIN_LOG VAL_EVERY
    python3 docs/campaign_torch/horizon.py plot WORKDIR OUT_DIR
    JAX_PLATFORMS=cpu python3 docs/campaign_torch/horizon.py bicubic_cpu WD
    python3 docs/campaign_torch/horizon.py dtype_cpu WD G_NPZ

until   runs CMD; after SECS it sends SIGINT to each
        ``tecogan_tpu_torch.main`` process among CMD and the processes
        below it (the training CLI: it saves its state where it stands
        between steps, or leaves the newest periodic
        ``state_iter{N}.pth``) and waits for CMD to end. Started from a
        foreground process, so that SIGINT is not ignored as it is in a
        shell's background jobs.
carry   copies a workdir's logs, ymls, metric JSONs and CSVs, and the
        newest ``state_iter{N}.pth`` of each run whose path holds NAME
        (all runs without --state, none with --state none), into OUT; the
        corpus, result PNGs and other checkpoints stay behind.
g_from_state  writes ``G_iter{N}.npz`` (the JAX layout ``VSRModel.save``
        writes) from a state file's generator weights.
ms      ms per iteration from the log lines' timestamps, over each window
        of 100 iterations that holds no validation: count, min, median,
        max.
plot    plots each run's train.log and validation JSON with
        ``scripts/monitor_training.py`` into OUT_DIR as
        ``<run>_monitor.png``.
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
"""

import argparse
import datetime
import os
import os.path as osp
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile

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


def carry(workdir, out, state=None):
    for root, _, files in os.walk(workdir):
        rel = osp.relpath(root, workdir)
        if rel.split(os.sep)[0] == "data" or "results" in rel.split(os.sep):
            continue
        keep = [f for f in files
                if f.endswith((".log", ".yml", ".json", ".csv", ".txt"))]
        states = sorted((f for f in files
                         if re.fullmatch(r"state_iter\d+\.pth", f)),
                        key=lambda f: int(re.findall(r"\d+", f)[0]))
        if states and (state is None or state in rel):
            keep.append(states[-1])
        for f in keep:
            os.makedirs(osp.join(out, rel), exist_ok=True)
            shutil.copy2(osp.join(root, f), osp.join(out, rel, f))
            print(f"carried {osp.join(rel, f)}")


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


def plot(workdir, out_dir):
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
                        osp.join(out_dir, f"{name}_monitor.png"))


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


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("until")
    p.add_argument("secs", type=float)
    p.add_argument("command", nargs=argparse.REMAINDER)
    p = sub.add_parser("carry")
    p.add_argument("workdir")
    p.add_argument("out")
    p.add_argument("--state", default=None)
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
    p = sub.add_parser("bicubic_cpu")
    p.add_argument("workdir")
    p = sub.add_parser("dtype_cpu")
    p.add_argument("workdir")
    p.add_argument("ckpt")
    a = ap.parse_args()
    if a.cmd == "until":
        sys.exit(until(a.secs, a.command))
    if a.cmd == "carry":
        carry(a.workdir, a.out, a.state)
    elif a.cmd == "g_from_state":
        g_from_state(a.state, a.out, a.nb, a.scale)
    elif a.cmd == "ms":
        print("windows %d, ms/iteration min %.2f, median %.2f, max %.2f"
              % ms(a.log, a.val_every))
    elif a.cmd == "plot":
        plot(a.workdir, a.out_dir)
    elif a.cmd == "bicubic_cpu":
        bicubic_cpu(a.workdir)
    else:
        dtype_cpu(a.workdir, a.ckpt)


if __name__ == "__main__":
    main()
