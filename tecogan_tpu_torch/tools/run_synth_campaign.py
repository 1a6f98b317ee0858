"""Full-schedule synthetic training campaign through the port's CLI (port
of ``scripts/run_synth_campaign.py``)::

    python -m tecogan_tpu_torch.tools.run_synth_campaign [stage] \\
        [--workdir W] [--frvsr_iter 40000] [--tecogan_iter 15000] \\
        [--degradation BD|BI] [--scale 4|2] [--precision mixed|fp32] \\
        [--smoke]

The standing quality check without real data: synthesize a seeded
parallax-motion video corpus, train FRVSR on the reference recipe (CB
pixel + warping losses, MultiStepLR) through ``python -m
tecogan_tpu_torch.main --mode train``, warm-start TecoGAN from it (the
reference recipe without the VGG feature loss: no ImageNet weights exist
offline), then score both models and a bicubic baseline on held-out
sequences with the official harness.

Stages (each resumable, state under ``--workdir``; no stage runs all):
  data   : train records (+ paired LR records for BI) and held-out PNG trees
  frvsr  : write train.yml, run the CLI's train mode
  tecogan: write train.yml (warm start from the FRVSR checkpoint), run it
  eval   : test mode for both models, the bicubic baseline, the official
           harness on all three, ``eval/summary.json``

The corpus is the JAX script's, pixel for pixel: the same seeds, the same
rng stream order and the same cv2 operators (``cv2.resize`` INTER_CUBIC,
``cv2.warpAffine`` INTER_LINEAR with BORDER_REFLECT, which samples on a
fixed-point 1/32 grid even for float images). cv2 is imported inside the
synthesis alone. Held-out frames are written by ``utils/png.py``. The
option dicts are the JAX script's key for key.

Everything that computes runs on the card: the CLIs get ``--gpu_ids 0``,
BI's LR and the bicubic baseline are computed there. ``main(argv,
device="cpu")`` (or ``device="cpu"`` to a stage function) runs on the CPU
and passes ``--gpu_ids -1``; without a card and without that request it
raises before any stage runs. The default workdir is
``build/synth_campaign`` in the repository (suffixed ``_bi``, ``_2x``,
``_fp32`` as the JAX script's), apart from the JAX script's.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import subprocess
import sys

import numpy as np
import torch

from . import resolve_device
from ..data.records import RecordWriter
from ..ops import apply_separable, downsample_bd, imresize_matlab
from ..ops.resize import resize_matrix
from ..utils.png import read_image, write_png
from ..utils.yaml_subset import safe_dump

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
DEFAULT_WORKDIR = osp.join(REPO, "build", "synth_campaign")

# training geometry, overridden by --smoke / --scale; PRECISION by
# --precision (the bf16-vs-fp32 training-quality twin)
GEOM = {"crop": 128, "tempo": 10, "scale": 4}
PRECISION = {"mixed": True}


def _gpu_ids(device) -> str:
    """The CLI's ``--gpu_ids`` for a resolved device."""
    dev = resolve_device(device)
    return "-1" if dev.type == "cpu" else str(dev.index or 0)


# --------------------------------------------------------------------------
# synthetic video
# --------------------------------------------------------------------------

def _multi_octave_texture(rng, h, w):
    """Smooth multi-scale texture in [0, 1], (h, w, 3) float32."""
    import cv2

    img = np.zeros((h, w, 3), np.float32)
    for cell in (8, 16, 32, 64, 128):
        gh, gw = max(2, -(-h // cell) + 1), max(2, -(-w // cell) + 1)
        noise = rng.random((gh, gw, 3), dtype=np.float32)
        up = cv2.resize(noise, (w, h), interpolation=cv2.INTER_CUBIC)
        img += np.sqrt(cell) * up
    lo, hi = img.min(), img.max()
    return (img - lo) / max(hi - lo, 1e-6)


def _sample(canvas, ox, oy, w, h):
    """Bilinear sample an (H, W, c) canvas at offset (ox, oy) -> (h, w, c)."""
    import cv2

    m = np.float32([[1, 0, -ox], [0, 1, -oy]])
    return cv2.warpAffine(canvas, m, (w, h), flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_REFLECT)


def synth_clip(rng, t, h, w, max_vel=2.5):
    """(t, h, w, 3) uint8 clip: two parallax layers, sub-pixel motion."""
    pad = int(np.ceil(t * max_vel)) + 4
    ch, cw = h + 2 * pad, w + 2 * pad
    bg = _multi_octave_texture(rng, ch, cw)
    fg = _multi_octave_texture(rng, ch, cw)
    # smooth blob mask from low-frequency noise
    m = _multi_octave_texture(rng, ch, cw)[..., :1]
    mask = np.clip((m - 0.55) * 12.0 + 0.5, 0.0, 1.0)
    v_bg = rng.uniform(-max_vel, max_vel, 2)
    v_fg = rng.uniform(-max_vel, max_vel, 2)
    frames = []
    for i in range(t):
        oxb, oyb = pad + v_bg[0] * i, pad + v_bg[1] * i
        oxf, oyf = pad + v_fg[0] * i, pad + v_fg[1] * i
        b = _sample(bg, oxb, oyb, w, h)
        f = _sample(fg, oxf, oyf, w, h)
        mk = _sample(mask, oxf, oyf, w, h)[..., None]
        frame = b * (1.0 - mk) + f * mk
        frame = frame * (1.0 + 0.02 * np.sin(0.4 * i))  # gain drift
        frames.append(np.clip(frame * 255.0, 0, 255).astype(np.uint8))
    return np.stack(frames)


def _bi_lr(clip, scale=None, device=None):
    """Matlab-imresize bicubic LR of a (t, h, w, 3) uint8 clip, uint8,
    computed in float32 on ``device`` (None: the card)."""
    scale = scale or GEOM["scale"]
    x = torch.from_numpy(clip).to(resolve_device(device), torch.float32)
    lr = imresize_matlab(x / 255.0, 1 / scale)
    return torch.clamp(torch.round(lr * 255.0), 0, 255).to(
        torch.uint8).cpu().numpy()


def _write_frames(seq_dir, frames):
    os.makedirs(seq_dir)
    for fi, frame in enumerate(frames):
        write_png(osp.join(seq_dir, f"{fi:04d}.png"), frame)


def stage_data(wd, n_train=64, t_train=16, hw_train=(192, 192),
               n_test=4, t_test=30, hw_test=(256, 448), seed=0,
               degradation="BD", device=None):
    rec_dir = osp.join(wd, "data", "GT.rec")
    lr_rec_dir = osp.join(wd, "data", "LR.rec")
    done = osp.exists(osp.join(rec_dir, "index.json"))
    if done and degradation == "BI":
        # a BD-era workdir (or a BI data stage killed between the two
        # writer.close() calls) has the GT half only; training would then
        # die late pointing at the missing LR.rec
        done = osp.exists(osp.join(lr_rec_dir, "index.json"))
        if not done:
            raise SystemExit(
                f"[data] {rec_dir} exists but {lr_rec_dir} is missing/"
                f"incomplete — this workdir was built without the paired "
                f"BI half. Use a fresh --workdir (or delete {wd}/data).")
    if done:
        print(f"[data] {rec_dir} exists, skipping")
    else:
        rng = np.random.default_rng(seed)
        writer = RecordWriter(rec_dir)
        lr_writer = RecordWriter(lr_rec_dir) if degradation == "BI" else None
        for i in range(n_train):
            clip = synth_clip(rng, t_train, *hw_train)
            writer.add_sequence(f"clip{i:03d}", clip)
            if lr_writer is not None:
                lr_writer.add_sequence(f"clip{i:03d}",
                                       _bi_lr(clip, device=device))
        writer.close()
        if lr_writer is not None:
            lr_writer.close()
        print(f"[data] wrote {n_train} train clips -> {rec_dir}")

    gt_dir = osp.join(wd, "data", "test_GT")
    lr_dir = osp.join(wd, "data", "test_LR")
    rng = np.random.default_rng(seed + 1)
    for i in range(n_test):
        seq_dir = osp.join(gt_dir, f"held{i:02d}")
        clip = synth_clip(rng, t_test, *hw_test)  # keep rng stream aligned
        if not osp.exists(seq_dir):
            _write_frames(seq_dir, clip)
        if degradation == "BI":
            lr_seq_dir = osp.join(lr_dir, f"held{i:02d}")
            if not osp.exists(lr_seq_dir):
                _write_frames(lr_seq_dir, _bi_lr(clip, device=device))
    print(f"[data] held-out GT -> {gt_dir}")
    return rec_dir, gt_dir


# --------------------------------------------------------------------------
# configs + CLI driving
# --------------------------------------------------------------------------

def _base_opt(wd, model_block, train_block, total_iter, test_freq,
              ckpt_freq, crop=128, tempo=10, degradation="BD"):
    rec_dir = osp.join(wd, "data", "GT.rec")
    gt_dir = osp.join(wd, "data", "test_GT")
    if degradation == "BI":
        degr_block = {"type": "BI"}
        train_ds = {"gt_seq_dir": rec_dir,
                    "lr_seq_dir": osp.join(wd, "data", "LR.rec"),
                    "gt_crop_size": crop}
        test_lr = osp.join(wd, "data", "test_LR")
    else:
        degr_block = {"type": "BD", "sigma": 1.5}
        train_ds = {"seq_dir": rec_dir, "crop_size": crop}
        test_lr = None
    return {
        "scale": GEOM["scale"], "manual_seed": 0, "verbose": False,
        "dataset": {
            "degradation": degr_block,
            "train": {
                "name": "SynthParallax", "filter_file": None,
                "data_type": "rgb", **train_ds,
                "batch_size_per_gpu": 4, "num_worker_per_gpu": 3,
                "pin_memory": True,
                # the synthetic corpus is ~113 MB: keep it on the device
                # and stream only sample plans
                "device_resident": True,
            },
            "test": {
                "name": "SynthHeldout", "gt_seq_dir": gt_dir,
                "lr_seq_dir": test_lr, "filter_file": None,
                "num_worker_per_gpu": 3, "pin_memory": True,
            },
        },
        "model": model_block,
        "train": {
            "tempo_extent": tempo, "start_iter": 0,
            "mixed_precision": PRECISION["mixed"],
            "moving_first_frame": True, "moving_factor": 0.7,
            "pixel_crit": {"type": "CB", "weight": 1, "reduction": "mean"},
            "warping_crit": {"type": "CB", "weight": 1, "reduction": "mean"},
            "total_iter": total_iter, **train_block,
        },
        "test": {
            "test_freq": test_freq, "save_res": False, "res_dir": None,
            "save_json": True, "json_dir": None,
            "padding_mode": "reflect", "num_pad_front": 5,
        },
        "metric": {"PSNR": {"colorspace": "y"}, "SSIM": {},
                   "tOF": {"colorspace": "y"}},
        "logger": {"log_freq": 100, "decay": 0.99, "ckpt_freq": ckpt_freq},
    }


def _block_yaml(opt):
    """``opt`` with each empty mapping (``"SSIM": {}``) as an empty value:
    the YAML subset has no flow ``{}``, and the metric calculator reads an
    empty body as ``{}``."""
    return {k: (_block_yaml(v) or None) if isinstance(v, dict) else v
            for k, v in opt.items()}


def _run_cli(exp_dir, opt, mode, device=None):
    """Write ``opt`` as ``exp_dir/<mode>.yml`` and run the port's CLI on it
    (``--gpu_ids -1`` where ``device`` is the CPU), its output appended to
    ``exp_dir/<mode>.log``. A failed run raises with the log's end."""
    gpu_ids = _gpu_ids(device)
    os.makedirs(exp_dir, exist_ok=True)
    opt_path = osp.join(exp_dir, f"{mode}.yml")
    with open(opt_path, "w") as f:
        f.write(safe_dump(_block_yaml(opt)))
    cmd = [sys.executable, "-m", "tecogan_tpu_torch.main", "--exp_dir",
           exp_dir, "--mode", mode, "--opt", opt_path, "--gpu_ids", gpu_ids]
    log = osp.join(exp_dir, f"{mode}.log")
    print(f"[cli] {' '.join(cmd)}\n      log: {log}")
    with open(log, "a") as lf:
        r = subprocess.run(cmd, cwd=REPO, stdout=lf, stderr=subprocess.STDOUT)
    if r.returncode:
        with open(log) as lf:
            tail = lf.read()[-3000:]
        raise RuntimeError(f"{' '.join(cmd)} exited with {r.returncode}; "
                           f"the end of {log}:\n{tail}")


def stage_frvsr(wd, total_iter, nf=64, nb=10, degradation="BD",
                device=None):
    exp_dir = osp.join(wd, f"FRVSR_Synth_{GEOM['scale']}xSR")
    model = {"name": "FRVSR",
             "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                           "nf": nf, "nb": nb}}
    train = {"generator": {
        "lr": 1.0e-4,
        "lr_schedule": {"type": "MultiStepLR",
                        "milestones": [int(total_iter * 0.4),
                                       int(total_iter * 0.8)],
                        "gamma": 0.5},
        "betas": [0.9, 0.999]}}
    opt = _base_opt(wd, model, train, total_iter,
                    test_freq=max(total_iter // 8, 1),
                    ckpt_freq=max(total_iter // 4, 1),
                    crop=GEOM["crop"], tempo=GEOM["tempo"],
                    degradation=degradation)
    _run_cli(exp_dir, opt, "train", device)
    return osp.join(exp_dir, "train", "ckpt", f"G_iter{total_iter}.npz")


def stage_tecogan(wd, frvsr_ckpt, total_iter, nf=64, nb=10,
                  degradation="BD", device=None):
    exp_dir = osp.join(wd, f"TecoGAN_Synth_{GEOM['scale']}xSR")
    model = {"name": "TecoGAN",
             "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                           "nf": nf, "nb": nb, "load_path": frvsr_ckpt},
             "discriminator": {"name": "STNet", "in_nc": 3,
                               "tempo_range": 3, "load_path": None}}
    train = {
        "generator": {"lr": 5.0e-5, "lr_schedule": {"type": "FixedLR"},
                      "betas": [0.9, 0.999]},
        "discriminator": {"update_policy": "adaptive",
                          "update_threshold": 0.4,
                          "crop_border_ratio": 0.75, "lr": 5.0e-5,
                          "lr_schedule": {"type": "FixedLR"},
                          "betas": [0.9, 0.999]},
        # feature_crit (VGG19 cosine) intentionally absent: no ImageNet
        # weights exist offline, and random VGG19 features need an
        # explicit allow_random_weights
        "pingpong_crit": {"type": "CB", "weight": 0.5, "reduction": "mean"},
        "gan_crit": {"type": "GAN", "weight": 0.01, "reduction": "mean"},
    }
    opt = _base_opt(wd, model, train, total_iter,
                    test_freq=max(total_iter // 6, 1),
                    ckpt_freq=max(total_iter // 3, 1),
                    crop=GEOM["crop"], tempo=GEOM["tempo"],
                    degradation=degradation)
    _run_cli(exp_dir, opt, "train", device)
    return osp.join(exp_dir, "train", "ckpt", f"G_iter{total_iter}.npz")


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def _read_frames(seq_dir, dev):
    """A PNG sequence as float32 (t, h, w, 3) in [0, 1] on ``dev``."""
    frames = np.stack([read_image(osp.join(seq_dir, fn))
                       for fn in sorted(os.listdir(seq_dir))])
    return torch.from_numpy(frames).to(dev, torch.float32) / 255.0


def _bicubic_baseline(wd, degradation="BD", device=None):
    """Degrade each held-out GT (BD blur+stride or Matlab BI bicubic),
    bicubic-upsample back, save PNGs — the no-model reference point."""
    dev = resolve_device(device)
    gt_dir = osp.join(wd, "data", "test_GT")
    out_root = osp.join(wd, "eval", "bicubic")
    for seq in sorted(os.listdir(gt_dir)):
        out_dir = osp.join(out_root, seq)
        if osp.exists(out_dir):
            continue
        if degradation == "BI":
            # upsample the SAME uint8-quantised LR PNGs the models are
            # tested on (stage_data's test_LR tree) — an unquantised
            # float LR would hand the baseline systematically cleaner
            # input than the models must absorb
            lr = _read_frames(osp.join(wd, "data", "test_LR", seq), dev)
            sr = imresize_matlab(lr, float(GEOM["scale"])).clamp(0.0, 1.0)
        else:
            s = GEOM["scale"]
            gt = _read_frames(osp.join(gt_dir, seq), dev).permute(0, 3, 1, 2)
            lr = downsample_bd(gt, s, sigma=1.5, pad_data=True)
            mh, mw = (torch.from_numpy(resize_matrix(
                "tecogan_bicubic", n, scale=s)).to(dev)
                for n in lr.shape[-2:])
            sr = apply_separable(lr, mh, mw).clamp(0.0, 1.0).permute(
                0, 2, 3, 1)
        sr = sr.cpu().numpy()
        _write_frames(out_dir, (sr * 255.0).round().astype(np.uint8))
    return out_root


def _test_model(wd, name, ckpt, nf=64, nb=10, degradation="BD",
                device=None):
    exp_dir = osp.join(wd, "eval", name)
    gt_dir = osp.join(wd, "data", "test_GT")
    if degradation == "BI":
        degr_block = {"type": "BI"}
        test_ds = {"gt_seq_dir": gt_dir,
                   "lr_seq_dir": osp.join(wd, "data", "test_LR")}
    else:
        degr_block = {"type": "BD", "sigma": 1.5}
        test_ds = {"gt_seq_dir": gt_dir}
    opt = {
        "scale": GEOM["scale"], "manual_seed": 0, "is_train": False,
        "dataset": {"degradation": degr_block,
                    "test1": {"name": "SynthHeldout", **test_ds,
                              "filter_file": None}},
        "model": {"name": "FRVSR",
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": nf, "nb": nb, "load_path": ckpt}},
        "test": {"test_freq": 0, "save_res": True,
                 "res_dir": osp.join(exp_dir, "results"),
                 "save_json": True,
                 "json_dir": osp.join(exp_dir, "metrics"),
                 "padding_mode": "reflect", "num_pad_front": 5},
        "metric": {"PSNR": {"colorspace": "y"}, "SSIM": {},
                   "tOF": {"colorspace": "y"}},
    }
    _run_cli(exp_dir, opt, "test", device)
    return osp.join(exp_dir, "results", "SynthHeldout",
                    osp.splitext(osp.basename(ckpt))[0])


# the official harness's console summary line (metrics.py prints
# "{k}, total frame {n}, total avg {x}, folder avg {y}"); the value class
# must escape '-' ('[+-e]' would be a character RANGE swallowing ,/:;<A-Z)
METRIC_LINE_RE = re.compile(
    r"^(\w+), total frame (\d+), total avg ([\d.+\-eEna]+), "
    r"folder avg ([\d.+\-eEna]+)")


def _official_metrics(wd, tag, res_root, device=None):
    """Run the official harness; parse the console summary into a dict."""
    gt_dir = osp.join(wd, "data", "test_GT")
    out = osp.join(wd, "eval", f"official_{tag}")
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "tecogan_tpu_torch.official_metrics.metrics",
           "--output", out, "--results", res_root, "--targets", gt_dir,
           "--gpu_ids", _gpu_ids(device)]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    print(r.stdout[-2000:])
    if r.returncode:
        print(r.stderr[-2000:])
        raise RuntimeError(f"official metrics failed for {tag}")
    summary = {}
    for line in r.stdout.splitlines():
        m = METRIC_LINE_RE.match(line.strip())
        if m:
            summary[m.group(1)] = {"frames": int(m.group(2)),
                                   "frame_avg": float(m.group(3)),
                                   "folder_avg": float(m.group(4))}
    return summary


def stage_eval(wd, frvsr_iter, tecogan_iter, nf=64, nb=10,
               degradation="BD", device=None):
    summary = {}
    bicubic_root = _bicubic_baseline(wd, degradation=degradation,
                                     device=device)
    summary["bicubic"] = _official_metrics(wd, "bicubic", bicubic_root,
                                           device)
    for name, it in ((f"FRVSR_Synth_{GEOM['scale']}xSR", frvsr_iter),
                     (f"TecoGAN_Synth_{GEOM['scale']}xSR", tecogan_iter)):
        ckpt = osp.join(wd, name, "train", "ckpt", f"G_iter{it}.npz")
        res_root = _test_model(wd, name, ckpt, nf=nf, nb=nb,
                               degradation=degradation, device=device)
        summary[name] = _official_metrics(wd, name, res_root, device)
    out = osp.join(wd, "eval", "summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    print(f"[eval] summary -> {out}")
    return summary


def main(argv=None, device=None):
    """``device``: None for the card; ``"cpu"`` to run on the CPU."""
    ap = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.run_synth_campaign")
    ap.add_argument("stage", nargs="?", default="all",
                    choices=["all", "data", "frvsr", "tecogan", "eval"])
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--frvsr_iter", type=int, default=40000)
    ap.add_argument("--tecogan_iter", type=int, default=15000)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny geometry + data for a CPU pipeline check")
    ap.add_argument("--degradation", default="BD", choices=["BD", "BI"],
                    help="BD: GT-only records + on-device blur/stride; "
                         "BI: paired GT+LR records (Matlab bicubic)")
    ap.add_argument("--scale", type=int, default=4, choices=[4, 2],
                    help="SR factor — 2 runs the 2x family recipe "
                         "(experiments_BD/FRVSR/FRVSR_REDS_2xSR_2GPU)")
    ap.add_argument("--precision", default="mixed",
                    choices=["mixed", "fp32"],
                    help="train.mixed_precision toggle for the bf16-vs-"
                         "fp32 training-quality twin")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    GEOM["scale"] = args.scale
    PRECISION["mixed"] = args.precision == "mixed"
    wd = args.workdir
    if wd == ap.get_default("workdir"):
        # keep corpora/runs from colliding across the experiment matrix
        if args.degradation == "BI":
            wd += "_bi"
        if args.scale != 4:
            wd += f"_{args.scale}x"
        if args.precision != "mixed":
            wd += f"_{args.precision}"
    os.makedirs(wd, exist_ok=True)

    nf, nb = 64, 10
    if args.smoke:
        nf, nb = 8, 2
        GEOM.update(crop=32, tempo=3)
        args.frvsr_iter = min(args.frvsr_iter, 6)
        args.tecogan_iter = min(args.tecogan_iter, 4)

    kw = dict(degradation=args.degradation, device=device)
    if args.stage in ("all", "data"):
        if args.smoke:
            stage_data(wd, n_train=6, t_train=8, hw_train=(96, 96),
                       n_test=2, t_test=10, hw_test=(96, 128), **kw)
        else:
            stage_data(wd, **kw)
    if args.stage in ("all", "frvsr"):
        stage_frvsr(wd, args.frvsr_iter, nf=nf, nb=nb, **kw)
    if args.stage in ("all", "tecogan"):
        frvsr_ckpt = osp.join(wd, f"FRVSR_Synth_{GEOM['scale']}xSR",
                              "train", "ckpt",
                              f"G_iter{args.frvsr_iter}.npz")
        assert osp.exists(frvsr_ckpt), frvsr_ckpt
        stage_tecogan(wd, frvsr_ckpt, args.tecogan_iter, nf=nf, nb=nb, **kw)
    if args.stage in ("all", "eval"):
        stage_eval(wd, args.frvsr_iter, args.tecogan_iter, nf=nf, nb=nb,
                   **kw)


if __name__ == "__main__":
    main()
