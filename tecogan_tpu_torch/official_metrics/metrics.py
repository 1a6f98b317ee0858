"""Publication-grade metric harness, TecoGAN protocol (port of
``tecogan_tpu/official_metrics/metrics.py``, after the reference's
`codes/official_metrics/metrics.py`):

- the first and last ``cutfr=2`` frames of each sequence are skipped;
- images are centre-cropped to 32-multiples with >=16px margins;
- PSNR and SSIM on the Y channel of the DUF-style YCbCr transform (float,
  not re-quantised); SSIM uses data_range = Y_pred.max() - Y_pred.min();
- tOF = mean end-point error between Farneback flows of consecutive GT
  and SR frames (grey, flows cropped), by OpenCV (cv2, imported when the
  harness runs);
- LPIPS (net-lin/alex v0.1, ``metrics/lpips.py``) and tLP100 =
  100*|LPIPS(gt_prev, gt) - LPIPS(sr_prev, sr)|, left out with a warning
  where the weights are missing;
- CSV output: per-folder frame series, then Avg / FolderAvg / FrameAvg
  rows, with the columns, rows and index pandas' ``to_csv`` gives the JAX
  package's (written here with the csv module).

Frames are PNGs, read by ``utils/png.py``. LPIPS runs on the card unless
the CPU is asked for (``--gpu_ids -1``; without CUDA and without it the
harness raises).

CLI: python -m tecogan_tpu_torch.official_metrics.metrics
         --output DIR --results d1,d2 --targets t1,t2 [--gpu_ids -1]
"""

from __future__ import annotations

import argparse
import csv
import os
import os.path as osp

import numpy as np

from ..metrics.metric_calculator import _FARNEBACK
from ..metrics.ssim import ssim as ssim_fn
from ..utils.png import read_image

__all__ = ["crop_32", "psnr_y", "ssim_y", "list_png", "evaluate_folders",
           "device_from_gpu_ids"]

_CUTFR = 2

# DUF-style RGB->YCbCr (float output, no rounding)
_T = np.array([
    [0.256788235294118, 0.504129411764706, 0.097905882352941],
    [-0.148223529411765, -0.290992156862745, 0.439215686274510],
    [0.439215686274510, -0.367788235294118, -0.071427450980392],
], dtype=np.float64)
_O = np.array([16.0, 128.0, 128.0])


def _luma(img_uint8_rgb):
    f = img_uint8_rgb.astype(np.float64)
    return f @ _T.T[:, 0] + _O[0]


def list_png(dirpath):
    files = [f for f in os.listdir(dirpath)
             if f.endswith(".png") and not f.startswith("IB")]
    files.sort()
    files.sort(key=lambda f: int("".join(filter(str.isdigit, f)) or -1))
    return [osp.join(dirpath, f) for f in files]


def crop_32(img):
    """Centre crop to 32-multiples, keeping >=16px margin per side."""
    oh, ow = img.shape[0], img.shape[1]
    h = (oh // 32) * 32
    w = (ow // 32) * 32
    while h > oh - 16:
        h -= 32
    while w > ow - 16:
        w -= 32
    if h <= 0 or w <= 0:
        # any dim < 48 px leaves no 32-multiple inside the margins
        raise ValueError(
            f"image {oh}x{ow} too small for the official protocol "
            f"(crop to 32-multiples with 16 px margins needs >=48 px "
            f"per side)")
    y, x = (oh - h) // 2, (ow - w) // 2
    return img[y:y + h, x:x + w], y, x


def _psnr_luma(yt, yo):
    d = yt - yo
    rmse = np.sqrt(np.mean(d * d))
    return float("inf") if rmse == 0 else 20 * np.log10(255.0 / rmse)


def psnr_y(tar, out):
    return _psnr_luma(_luma(tar), _luma(out))


def ssim_y(tar, out):
    yt, yo = _luma(tar), _luma(out)
    return ssim_fn(yt, yo, data_range=yo.max() - yo.min())


def _pair_frames(outs, tars, rdir, tdir):
    """Pair result/target frame paths: by sorted order where both lists
    hold the same names, or equally many frames whose names do not overlap
    at all (names may differ between pipelines); by matching basenames,
    with a WARNING, where the counts differ or equal counts hold different
    but overlapping names (each dir missing another frame: pairing by
    position would put every later pair a frame off)."""
    o_names = {osp.basename(p): p for p in outs}
    t_names = {osp.basename(p): p for p in tars}
    if len(outs) == len(tars) and (o_names.keys() == t_names.keys()
                                   or not o_names.keys() & t_names.keys()):
        return outs, tars
    common = [n for n in sorted(o_names) if n in t_names]
    common.sort(key=lambda f: int("".join(filter(str.isdigit, f)) or -1))
    if not common:
        raise SystemExit(
            f"{rdir} has {len(outs)} frames but {tdir} has {len(tars)} and "
            f"no basenames match — refusing to guess an alignment")
    dropped = (sorted(set(o_names) - set(common))
               + sorted(set(t_names) - set(common)))
    print(f"WARNING: {rdir} has {len(outs)} frames but {tdir} has "
          f"{len(tars)}; scoring the {len(common)} basename-matched pairs "
          f"(unmatched: {', '.join(dropped[:5])}"
          f"{', ...' if len(dropped) > 5 else ''})")
    return [o_names[n] for n in common], [t_names[n] for n in common]


def device_from_gpu_ids(gpu_ids: str):
    """The CLI's ``--gpu_ids`` as a device: '-1' the CPU, else a card
    (``nn.select_device``: raises without CUDA)."""
    from ..nn import select_device

    ids = [int(i) for i in str(gpu_ids).split(",") if i != ""]
    return select_device({"device_ids": [] if ids == [-1] else ids})


def _try_lpips(device):
    from ..metrics.lpips import LPIPS

    try:
        return LPIPS(device=device)
    except FileNotFoundError as e:
        print(f"WARNING: LPIPS/tLP100 disabled — {e}")
        return None


def _expand_seq_dirs(result_dirs, target_dirs):
    """Accept per-sequence PNG dirs or PARENT dirs of sequence subdirs
    (matching subdirectory names expand pairwise); frameless pairs are
    dropped with a warning."""
    r_out, t_out = [], []
    for rdir, tdir in zip(result_dirs, target_dirs):
        if not osp.isdir(rdir) or not osp.isdir(tdir):
            print(f"WARNING: skipping non-existent dir pair: {rdir} vs "
                  f"{tdir}")
            continue
        if list_png(rdir) and list_png(tdir):
            r_out.append(rdir)
            t_out.append(tdir)
            continue
        t_by_name = osp.join(tdir, osp.basename(osp.normpath(rdir)))
        if list_png(rdir) and osp.isdir(t_by_name) and list_png(t_by_name):
            r_out.append(rdir)
            t_out.append(t_by_name)
            continue
        subs = sorted(d for d in os.listdir(rdir)
                      if osp.isdir(osp.join(rdir, d)))
        matched = [d for d in subs if osp.isdir(osp.join(tdir, d))]
        expanded = [(osp.join(rdir, d), osp.join(tdir, d)) for d in matched
                    if list_png(osp.join(rdir, d))
                    and list_png(osp.join(tdir, d))]
        if not expanded:
            print(f"WARNING: no scorable PNG sequences in {rdir} vs {tdir} "
                  "(need PNGs directly in both dirs, or matching sequence "
                  "subdirs containing them)")
            continue
        for r, t in expanded:
            r_out.append(r)
            t_out.append(t)
    return r_out, t_out


def _cell(v, float32):
    """A value as pandas' to_csv writes it: float32 by its shortest repr,
    float64 by repr, NaN as an empty field."""
    if np.isnan(v):
        return ""
    return str(np.float32(v)) if float32 else repr(float(v))


def _append_frame(path, columns: dict, float32: bool, first: bool):
    """Append a DataFrame of the given columns (equal or unequal lengths,
    aligned on a 0..n-1 index) as ``DataFrame.to_csv`` does: a header row
    with an unnamed index column, then one row per index."""
    n = max((len(v) for v in columns.values()), default=0)
    with open(path, "w" if first else "a", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(columns))
        for i in range(n):
            w.writerow([i] + [_cell(v[i], float32) if i < len(v) else ""
                              for v in columns.values()])


def evaluate_folders(result_dirs, target_dirs, output_dir,
                     device="cuda"):
    """Score each result dir against its target dir; write
    ``output_dir/metrics.csv`` and ``metricsfile.txt``. Returns {metric:
    (frames, frame average, folder average)}."""
    import cv2

    os.makedirs(output_dir, exist_ok=True)
    if len(result_dirs) != len(target_dirs):
        raise SystemExit(
            f"--results has {len(result_dirs)} dirs but --targets has "
            f"{len(target_dirs)}; the lists pair positionally")
    result_dirs, target_dirs = _expand_seq_dirs(result_dirs, target_dirs)
    if not result_dirs:
        raise SystemExit(
            "no scorable sequence pairs — nothing was evaluated")
    lpips = _try_lpips(device)
    keys = ["PSNR", "SSIM", "tOF"] + (["LPIPS", "tLP100"] if lpips else [])

    sum_d = {k: 0.0 for k in keys}
    len_d = {k: 0 for k in keys}
    folder_d = {k: 0.0 for k in keys}
    folder_n = {k: 0 for k in keys}
    avg_rows = {k: [] for k in keys}

    log_path = osp.join(output_dir, "metricsfile.txt")
    csv_path = osp.join(output_dir, "metrics.csv")
    with open(log_path, "a") as log:
        for fi, (rdir, tdir) in enumerate(zip(result_dirs, target_dirs)):
            outs, tars = _pair_frames(list_png(rdir), list_png(tdir), rdir,
                                      tdir)
            n = len(outs)
            series = {k: [] for k in keys}
            pre = {}

            for i in range(_CUTFR, n - _CUTFR):
                out = read_image(outs[i])
                tar = read_image(tars[i])
                mh = min(out.shape[0], tar.shape[0])
                mw = min(out.shape[1], tar.shape[1])
                out, tar = out[:mh, :mw], tar[:mh, :mw]

                out_g = cv2.cvtColor(out, cv2.COLOR_RGB2GRAY)
                tar_g = cv2.cvtColor(tar, cv2.COLOR_RGB2GRAY)
                if i > _CUTFR:
                    t_of = cv2.calcOpticalFlowFarneback(
                        pre["tar_g"], tar_g, None, **_FARNEBACK)
                    o_of = cv2.calcOpticalFlowFarneback(
                        pre["out_g"], out_g, None, **_FARNEBACK)
                    t_of, _, _ = crop_32(t_of)
                    o_of, _, _ = crop_32(o_of)
                    d = t_of - o_of
                    series["tOF"].append(
                        float(np.mean(np.sqrt(np.sum(d * d, -1)))))
                pre["tar_g"], pre["out_g"] = tar_g, out_g

                tar_c, _, _ = crop_32(tar)
                out_c, _, _ = crop_32(out)
                yt, yo = _luma(tar_c), _luma(out_c)  # shared by PSNR + SSIM
                series["PSNR"].append(_psnr_luma(yt, yo))
                series["SSIM"].append(ssim_fn(yt, yo,
                                              data_range=yo.max() - yo.min()))

                if lpips:
                    series["LPIPS"].append(float(lpips(tar_c, out_c)[0]))
                    if i > _CUTFR:
                        d0t = float(lpips(pre["tar_c"], tar_c)[0])
                        d1t = float(lpips(pre["out_c"], out_c)[0])
                        series["tLP100"].append(abs(d0t - d1t) * 100.0)
                    pre["tar_c"], pre["out_c"] = tar_c, out_c

            cols = {}
            for k in keys:
                arr = np.float32(series[k])
                cols[f"{k}_{fi:02d}"] = arr
                mean = float(arr.mean()) if len(arr) else float("nan")
                avg_rows[k].append(mean)
                if len(arr):  # an empty series (too short a sequence)
                    sum_d[k] += float(arr.sum())  # must not poison sums
                    len_d[k] += len(arr)
                    folder_d[k] += mean
                    folder_n[k] += 1
            _append_frame(csv_path, cols, float32=True, first=fi == 0)
            log.write(f"folder {fi}: {rdir}\n")

        if all(len_d[k] == 0 for k in keys):
            raise SystemExit(
                "no frames were scorable (every sequence has <= "
                f"{2 * _CUTFR} frames; the protocol skips cutfr={_CUTFR} "
                "at each end) — nothing was evaluated")

        summary = {}
        for k in keys:
            frame_avg = sum_d[k] / max(len_d[k], 1)
            folder_avg = folder_d[k] / max(folder_n[k], 1)
            summary[k] = (len_d[k], frame_avg, folder_avg)
            msg = (f"{k}, total frame {len_d[k]}, total avg "
                   f"{frame_avg:02.4f}, folder avg {folder_avg:02.4f}")
            print(msg)
            log.write(msg + "\n")

        _append_frame(csv_path, {f"Avg_{k}": np.float32(avg_rows[k])
                                 for k in keys}, float32=True, first=False)
        _append_frame(csv_path, {f"FolderAvg_{k}": [summary[k][2]]
                                 for k in keys}, float32=False, first=False)
        _append_frame(csv_path, {f"FrameAvg_{k}": [summary[k][1]]
                                 for k in keys}, float32=False, first=False)
    print("Finished.")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output", required=True)
    p.add_argument("--results", required=True)
    p.add_argument("--targets", required=True)
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="the card LPIPS runs on (-1 for the CPU)")
    args = p.parse_args(argv)
    return evaluate_folders(args.results.split(","), args.targets.split(","),
                            args.output,
                            device=device_from_gpu_ids(args.gpu_ids))


if __name__ == "__main__":
    main()
