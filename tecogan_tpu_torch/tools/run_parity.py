"""One-command published-checkpoint parity run on the card (port of
``scripts/run_parity.py``)::

    python -m tecogan_tpu_torch.tools.run_parity \\
        --ckpt pretrained_models/TecoGAN_BD_iter500000.pth \\
        --gt_root data/Vid4/GT --degradation BD --scale 4 --model TecoGAN

It (1) writes a test config around the checkpoint (a reference ``.pth``
or an ``.npz``) as ``<workdir>/exp/test.yml``, in the YAML subset that
``utils/yaml_subset.py`` reads (the port does not import PyYAML); (2) runs
the port's test mode (``python -m tecogan_tpu_torch.main --mode test``);
(3) links the SR sequences into the reference's ``results/<DS>/<MODEL>/``
layout; (4) scores them with the port's official harness
(``official_metrics.metrics.evaluate_folders``: cutfr=2, crop to 32,
Y-PSNR/SSIM, tOF, LPIPS, tLP100); (5) prints the measured numbers beside
the reference's published row with each delta.

LPIPS and tLP100 need the ImageNet backbone and the v0.1 heads under
``pretrained_models/lpips/``; without them those two columns are skipped
with a warning and the rest still run. The checkpoints and the Vid4/ToS3
data are not in the repository.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil

# The published rows (dataset, model, degradation) -> {metric: value}, all
# 4x; copied from scripts/run_parity.py lines 38-57 (BASELINE.md, from the
# reference's resources/benchmark.png).
REFERENCE_ROWS = {
    ("Vid4", "FRVSR", "BD"): {"PSNR": 27.06, "LPIPS": 0.245, "tOF": 0.202,
                              "tLP100": 1.094},
    ("Vid4", "TecoGAN", "BD"): {"PSNR": 26.01, "LPIPS": 0.152, "tOF": 0.194,
                                "tLP100": 0.515},
    ("ToS3", "FRVSR", "BD"): {"PSNR": 33.78, "LPIPS": 0.136, "tOF": 0.140,
                              "tLP100": 0.496},
    ("ToS3", "TecoGAN", "BD"): {"PSNR": 33.26, "LPIPS": 0.090, "tOF": 0.136,
                                "tLP100": 0.205},
    ("Vid4", "FRVSR", "BI"): {"PSNR": 26.31, "LPIPS": 0.291, "tOF": 0.186,
                              "tLP100": 1.430},
    ("Vid4", "TecoGAN", "BI"): {"PSNR": 24.93, "LPIPS": 0.184, "tOF": 0.201,
                                "tLP100": 0.573},
    ("ToS3", "FRVSR", "BI"): {"PSNR": 33.46, "LPIPS": 0.180, "tOF": 0.146,
                              "tLP100": 0.780},
    ("ToS3", "TecoGAN", "BI"): {"PSNR": 31.79, "LPIPS": 0.122, "tOF": 0.151,
                                "tLP100": 0.640},
}


def build_test_opt(args):
    """The test mode config around ``args.ckpt`` (the JAX script's)."""
    dataset = {
        "degradation": ({"type": "BD", "sigma": 1.5} if args.degradation
                        == "BD" else {"type": "BI"}),
        "test1": {"name": args.dataset, "gt_seq_dir": args.gt_root,
                  "lr_seq_dir": args.lr_root},
    }
    return {
        "scale": args.scale, "manual_seed": 0, "verbose": False,
        "dataset": dataset,
        "model": {"name": "FRVSR",  # the generator alone runs in test mode
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": args.nf, "nb": args.nb,
                                "load_path": args.ckpt}},
        "test": {"save_res": True, "res_dir": None, "save_json": True,
                 "json_dir": None, "padding_mode": "reflect",
                 "num_pad_front": 2},
        "metric": {"PSNR": {"colorspace": "y"}},
    }


def parse_frame_avg(csv_path):
    """The last ``FrameAvg_*`` block of the harness's metrics.csv ->
    {metric: value}."""
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    hdr_i = max(i for i, ln in enumerate(lines) if "FrameAvg_PSNR" in ln)
    hdr = [h.replace("FrameAvg_", "") for h in lines[hdr_i].split(",")[1:]]
    vals = [float(v) for v in lines[hdr_i + 1].split(",")[1:]]
    return dict(zip(hdr, vals))


def _link_fresh(link, target):
    """``link`` -> ``target``, replacing a link left by an earlier run (a
    stale one would score against another tree); a real directory there
    is refused."""
    if osp.islink(link) or osp.exists(link):
        if osp.isdir(link) and not osp.islink(link):
            raise SystemExit(f"{link} is a real directory (expected a "
                             "symlink managed by this tool): refusing to "
                             "replace it")
        os.remove(link)
    os.symlink(osp.abspath(target), link)


def main(argv=None, device=None):
    """``device``: None for the card; ``"cpu"`` runs test mode
    (``--gpu_ids -1``) and the harness on the CPU. Returns the measured
    frame averages."""
    from ..main import main as teco_main
    from ..official_metrics.metrics import evaluate_folders
    from ..utils.yaml_subset import safe_dump
    from . import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.run_parity")
    p.add_argument("--ckpt", required=True,
                   help="generator checkpoint (.pth reference format or "
                        ".npz)")
    p.add_argument("--gt_root", required=True,
                   help="GT root with one subdir per sequence, e.g. "
                        "data/Vid4/GT")
    p.add_argument("--lr_root", default=None,
                   help="pre-degraded LR root (required for BI; BD "
                        "degrades on the fly when omitted)")
    p.add_argument("--degradation", choices=["BD", "BI"], default="BD")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--model", choices=["FRVSR", "TecoGAN"], default="TecoGAN",
                   help="which published row to compare against (the test "
                        "graph is the generator either way)")
    p.add_argument("--dataset", default=None,
                   help="Vid4|ToS3|... (default: gt_root's parent's name)")
    p.add_argument("--nf", type=int, default=64)
    p.add_argument("--nb", type=int, default=10)
    p.add_argument("--workdir", default="parity_run",
                   help="scratch dir for the exp/results/metric tree")
    args = p.parse_args(argv)

    if args.degradation == "BI" and not args.lr_root:
        raise SystemExit("--degradation BI needs --lr_root (make it with "
                         "python -m tecogan_tpu_torch.tools.generate_lr_bi)")
    if args.dataset is None:
        parent = osp.basename(osp.dirname(osp.abspath(args.gt_root)))
        args.dataset = parent or "Vid4"
    dev = resolve_device(device)
    gpu_ids = "-1" if dev.type == "cpu" else str(dev.index or 0)

    ckpt_tag = osp.splitext(osp.basename(args.ckpt))[0]
    model_tag = f"{args.model}_{args.degradation}_{ckpt_tag}"

    # 1-2. the config, then test mode
    exp_dir = osp.join(args.workdir, "exp")
    os.makedirs(exp_dir, exist_ok=True)
    yml = osp.join(exp_dir, "test.yml")
    with open(yml, "w") as f:
        f.write(safe_dump(build_test_opt(args)))
    teco_main(["--exp_dir", exp_dir, "--mode", "test", "--opt", yml,
               "--gpu_ids", gpu_ids])

    # 3. the reference's results/ layout, each sequence a link
    res_root = osp.join(exp_dir, "test", "results", args.dataset, ckpt_tag)
    if not osp.isdir(res_root):
        raise SystemExit(f"test mode produced no results under {res_root}")
    off_dir = osp.join(args.workdir, "results", args.dataset, model_tag)
    if osp.isdir(off_dir):
        shutil.rmtree(off_dir)
    os.makedirs(off_dir)
    for seq in sorted(os.listdir(res_root)):
        src = osp.join(res_root, seq)
        if osp.isdir(src):
            os.symlink(osp.abspath(src), osp.join(off_dir, seq))

    # 4. the official harness on results/<DS>/<MODEL>/ and data/<DS>/GT
    gt_link = osp.join(args.workdir, "data", args.dataset, "GT")
    os.makedirs(osp.dirname(gt_link), exist_ok=True)
    _link_fresh(gt_link, args.gt_root)
    seqs = sorted(d for d in os.listdir(off_dir)
                  if osp.isdir(osp.join(off_dir, d)))
    evaluate_folders([osp.join(off_dir, s) for s in seqs],
                     [osp.join(gt_link, s) for s in seqs],
                     osp.join(off_dir, "metric_log"), device=dev)

    # 5. beside the published row (every row is 4x)
    csv_path = osp.join(off_dir, "metric_log", "metrics.csv")
    got = parse_frame_avg(csv_path)
    ref = (REFERENCE_ROWS.get((args.dataset, args.model, args.degradation))
           if args.scale == 4 else None)
    print(f"\n=== {model_tag} on {args.dataset} ({len(seqs)} sequences) ===")
    if ref is None:
        print(f"(no published reference row for this dataset/model/"
              f"degradation at {args.scale}x: measured values only)")
    width = max(len(k) for k in got)
    for k, v in got.items():
        line = f"  {k:<{width}}  measured {v:8.4f}"
        if ref and k in ref:
            delta = 100.0 * (v - ref[k]) / ref[k]
            line += f"   reference {ref[k]:8.4f}   delta {delta:+6.2f}%"
        print(line)
    if ref and "tOF" in got:
        ok = abs(got["tOF"] - ref["tOF"]) <= 0.01 * ref["tOF"]
        print(f"  north-star tOF within 1%: {'YES' if ok else 'NO'}")
    print(f"  full CSV: {csv_path}")
    return got


if __name__ == "__main__":
    main()
