"""Test-time folder datasets (copied from ``tecogan_tpu/data/datasets.py``
lines 300-381, with PNG frames read by ``utils/png.py`` instead of cv2).

Sequences are (t, h, w, c) numpy: GT uint8, LR float32 in [0, 1]. The
training clip datasets are not ported yet.
"""

from __future__ import annotations

import logging
import os
import os.path as osp

import numpy as np

from ..utils.paths import retrieve_files
from ..utils.png import read_png

__all__ = ["PairedFolderDataset", "UnpairedFolderDataset"]


def _select_keys(root, filter_file=None, filter_list=None):
    keys = sorted(os.listdir(root))
    sel = set(keys)
    if filter_file:
        with open(filter_file) as f:
            sel = {line.strip() for line in f if line.strip()}
    elif filter_list:
        sel = set(filter_list)
    return sorted(sel & set(keys))


def _read_seq(seq_dir, as_float):
    seq = np.stack([read_png(p) for p in retrieve_files(seq_dir)])
    if as_float:
        seq = seq.astype(np.float32) / 255.0
    return seq


class PairedFolderDataset:
    """Whole GT+LR sequences from PNG folders (reference counterpart:
    `paired_folder_dataset.py:12-63`). gt uint8, lr float32, both thwc."""

    def __init__(self, gt_seq_dir, lr_seq_dir, filter_file=None,
                 filter_list=None, **_):
        self.gt_seq_dir = gt_seq_dir
        self.lr_seq_dir = lr_seq_dir
        gt_keys = set(os.listdir(gt_seq_dir))
        lr_keys = set(os.listdir(lr_seq_dir))
        selected = set(_select_keys(gt_seq_dir, filter_file, filter_list))
        self.keys = sorted(selected & gt_keys & lr_keys)
        dropped = sorted((selected & gt_keys) - lr_keys)
        if dropped:
            # same intersection semantics as the reference
            # (`paired_folder_dataset.py:22`), but dropping sequences
            # changes every dataset-average metric — say so
            logging.getLogger("tecogan").warning(
                "PairedFolderDataset: %d GT sequence(s) have no matching "
                "LR folder under %s and will be SKIPPED: %s",
                len(dropped), lr_seq_dir, ", ".join(dropped[:8]))

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, item):
        key = self.keys[item]
        return {
            "gt": _read_seq(osp.join(self.gt_seq_dir, key), as_float=False),
            "lr": _read_seq(osp.join(self.lr_seq_dir, key), as_float=True),
            "seq_idx": key,
            "frm_idx": sorted(os.listdir(osp.join(self.gt_seq_dir, key))),
        }


class UnpairedFolderDataset:
    """GT-only sequences; LR generated downstream by on-the-fly BD
    (`unpaired_folder_dataset.py:12-52`)."""

    def __init__(self, gt_seq_dir, filter_file=None, filter_list=None, **_):
        self.gt_seq_dir = gt_seq_dir
        self.keys = _select_keys(gt_seq_dir, filter_file, filter_list)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, item):
        key = self.keys[item]
        return {
            "gt": _read_seq(osp.join(self.gt_seq_dir, key), as_float=False),
            "seq_idx": key,
            "frm_idx": sorted(os.listdir(osp.join(self.gt_seq_dir, key))),
        }
