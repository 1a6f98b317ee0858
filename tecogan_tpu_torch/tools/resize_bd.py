"""Offline BD LR generation: Gaussian blur + stride-s downsampling (port of
``scripts/resize_bd.py``)::

    python -m tecogan_tpu_torch.tools.resize_bd --gt_dir data/Vid4/GT \\
        --lr_dir data/Vid4/Gaussian4xLR --scale 4 --sigma 1.5

Each sequence directory under ``--gt_dir`` is read with the test loader's
reader (``data/datasets.py::_read_seq``: PNG and JPEG frames, recursive,
sorted), degraded on the card by the same separable operator matrices as
the training step and test mode's on-the-fly BD (``ops.degrade.
downsample_bd``, reflect padding, float32), quantised by
``ops.color.float32_to_uint8`` and written by ``ops.color.save_sequence``
under the GT frames' names. Every frame is written as a lossless PNG, a
``.jpg`` name included (the JAX script's cv2 writes JPEG there).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from . import resolve_device
from ..data.datasets import _read_seq
from ..ops.color import float32_to_uint8, save_sequence
from ..ops.degrade import downsample_bd
from ..utils.paths import retrieve_files


def main(argv=None, device=None):
    """``device``: None for the card; ``"cpu"`` to run on the CPU."""
    p = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.resize_bd")
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--lr_dir", required=True)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--sigma", type=float, default=1.5)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    for seq in sorted(os.listdir(args.gt_dir)):
        seq_dir = osp.join(args.gt_dir, seq)
        if not osp.isdir(seq_dir):
            continue
        gt = _read_seq(seq_dir, as_float=True)  # (t, h, w, c) float32
        x = torch.from_numpy(gt).to(dev).permute(0, 3, 1, 2)
        lr = downsample_bd(x, args.scale, sigma=args.sigma, pad_data=True)
        lr = lr.permute(0, 2, 3, 1).cpu().numpy()
        # the names from the lister _read_seq read the frames with
        frm_idx = [osp.basename(f) for f in retrieve_files(seq_dir)]
        save_sequence(osp.join(args.lr_dir, seq), float32_to_uint8(lr),
                      frm_idx, to_bgr=True)
        print(f"{seq}: {gt.shape} -> {lr.shape}")


if __name__ == "__main__":
    main()
