"""Test-mode metric calculator: PSNR, SSIM and tOF (port of
``tecogan_tpu/metrics/metric_calculator.py``).

Per-frame metrics -> per-sequence means -> dataset average, and the JSON
file keyed by model index, as in the JAX package:

- PSNR on RGB or Y (DUF/BasicSR YCbCr), float64, 20*log10(255/RMSE);
- SSIM on Y (``metrics/ssim.py``);
- tOF: mean end-point error between OpenCV's Farneback flows of
  consecutive GT and SR frames, in grey. cv2 is imported when tOF is
  configured; where it is missing, tOF is left out with a WARNING;
- LPIPS is not ported yet (ROADMAP Queue 1 item 8): it is always left
  out with a WARNING, as the JAX package does when its weights are missing.

One process computes every sequence, so there is nothing to gather across
processes.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import re

import numpy as np

from ..ops.color import rgb_to_ycbcr
from ..utils.logging_utils import log_info, log_warning
from .ssim import ssim

__all__ = ["MetricCalculator", "create_metric_calculator"]

_FARNEBACK = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                  poly_n=5, poly_sigma=1.2, flags=0)
_KNOWN_METRICS = ("PSNR", "SSIM", "LPIPS", "tOF")


def create_metric_calculator(opt):
    if "metric" in opt and opt["metric"] is not None:
        return MetricCalculator(opt)
    return None


class MetricCalculator:
    def __init__(self, opt):
        # a key with an empty YAML body ("metric:\n  PSNR:") parses to
        # None — normalise to {} so the .get(...) defaults below apply
        self.metric_opt = {k: (v or {}) for k, v in opt["metric"].items()}
        unknown = [m for m in self.metric_opt if m not in _KNOWN_METRICS]
        if unknown:
            # a typo'd key would otherwise collect no frames and turn the
            # dataset average into NaN
            raise ValueError(
                f"unsupported metric(s) {unknown}; supported here: "
                f"{list(_KNOWN_METRICS)}")
        self.psnr_colorspace = self.metric_opt.get(
            "PSNR", {}).get("colorspace", "y")
        if "LPIPS" in self.metric_opt:
            self._drop("LPIPS", "not ported to tecogan_tpu_torch yet "
                       "(ROADMAP Queue 1 item 8)")
        self._cv2 = None
        if "tOF" in self.metric_opt:
            try:
                import cv2
            except ImportError as e:
                self._drop("tOF", f"OpenCV (cv2) could not be imported, and "
                           f"tOF needs its Farneback flow ({e})")
            else:
                self._cv2 = cv2
        self.reset()

    def _drop(self, metric, reason):
        """Leave ``metric`` out, loudly; the rest of the stack still runs."""
        log_warning(f"WARNING: {metric} disabled — {reason}")
        del self.metric_opt[metric]

    def reset(self):
        self.metric_dict = {}
        self.avg_metric_dict = {}

    # ------------------------------------------------------------- sequences
    def _gray(self, img):
        return self._cv2.cvtColor(img, self._cv2.COLOR_RGB2GRAY)

    def compute_sequence_metrics(self, seq_idx, true_seq, pred_seq):
        """true/pred: (t, h, w, c) uint8 RGB."""
        per_frame = {m: [] for m in self.metric_opt}
        prev = None
        for i in range(true_seq.shape[0]):
            t_img, p_img = true_seq[i], pred_seq[i]
            # crop the larger to the smaller if sizes differ
            mh = min(t_img.shape[0], p_img.shape[0])
            mw = min(t_img.shape[1], p_img.shape[1])
            t_img, p_img = t_img[:mh, :mw], p_img[:mh, :mw]
            cur_y = None  # per-frame Y cache shared by PSNR(y) and SSIM

            def luma_pair():
                nonlocal cur_y
                if cur_y is None:
                    cur_y = (
                        rgb_to_ycbcr(t_img)[..., 0].astype(np.float64),
                        rgb_to_ycbcr(p_img)[..., 0].astype(np.float64))
                return cur_y

            if "PSNR" in self.metric_opt:
                pair = ((t_img, p_img) if self.psnr_colorspace == "rgb"
                        else luma_pair())
                per_frame["PSNR"].append(self._psnr(*pair))
            if "SSIM" in self.metric_opt:
                per_frame["SSIM"].append(self._ssim(*luma_pair()))
            if "tOF" in self.metric_opt:
                cur_gray = (self._gray(t_img), self._gray(p_img))
                if prev is not None:
                    per_frame["tOF"].append(
                        self._tof(prev[0], cur_gray[0], prev[1],
                                  cur_gray[1]))
                prev = cur_gray
        self.metric_dict[seq_idx] = per_frame

    @staticmethod
    def _psnr(a, b):
        rmse = np.sqrt(np.mean(
            (a.astype(np.float64) - b.astype(np.float64)) ** 2))
        return np.inf if rmse == 0 else 20 * np.log10(255.0 / rmse)

    @staticmethod
    def _ssim(a, b):
        return ssim(a, b, data_range=255.0)

    def _tof(self, t_prev_g, t_cur_g, p_prev_g, p_cur_g):
        """EPE between GT and SR Farneback flows of grey frames."""
        flow = self._cv2.calcOpticalFlowFarneback
        true_of = flow(t_prev_g, t_cur_g, None, **_FARNEBACK)
        pred_of = flow(p_prev_g, p_cur_g, None, **_FARNEBACK)
        d = true_of - pred_of
        return float(np.mean(np.sqrt(np.sum(d * d, axis=-1))))

    # --------------------------------------------------------------- results
    def gather(self, seq_idx_lst):
        for seq_idx in seq_idx_lst:
            if seq_idx not in self.metric_dict:
                continue
            self.avg_metric_dict[seq_idx] = {
                m: float(np.mean(v)) if v else float("nan")
                for m, v in self.metric_dict[seq_idx].items()
            }

    def average(self):
        """Dataset average per metric. Sequences whose series was empty
        (tOF needs >=2 frames) carry NaN from gather(); they are excluded
        from the average instead of poisoning it."""
        out = {}
        for m in self.metric_opt:
            vals = [seq[m] for seq in self.avg_metric_dict.values()
                    if not np.isnan(seq[m])]
            out[m] = float(np.mean(vals)) if vals else float("nan")
        return out

    def display(self):
        for seq_idx, md in self.avg_metric_dict.items():
            log_info(f"Sequence: {seq_idx}")
            for m, v in md.items():
                log_info(f"\t{m}: {v:.6f}")
        log_info("Average")
        for m, v in self.average().items():
            log_info(f"\t{m}: {v:.6f}")

    def save(self, model_idx, save_path, override=False):
        os.makedirs(osp.dirname(save_path) or ".", exist_ok=True)
        json_dict = {}
        if osp.exists(save_path):
            with open(save_path) as f:
                json_dict = json.load(f)
        entry = json_dict.setdefault(model_idx, {})
        for m, v in self.average().items():
            if m in entry and not override:
                continue
            entry[m] = f"{v:.6f}"

        # numeric sort for *_iter<N> keys; other checkpoint names (e.g.
        # 'G', 'TecoGAN_4x') sort lexically after them
        def sort_key(kv):
            m = re.search(r"iter(\d+)", kv[0])
            return (0, int(m.group(1)), kv[0]) if m else (1, 0, kv[0])

        json_dict = dict(sorted(json_dict.items(), key=sort_key))
        with open(save_path, "w") as f:
            json.dump(json_dict, f, sort_keys=False, indent=4)
