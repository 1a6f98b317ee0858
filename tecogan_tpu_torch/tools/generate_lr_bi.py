"""Offline BI LR generation: Matlab-compatible antialiased bicubic (port of
``scripts/generate_lr_bi.py``)::

    python -m tecogan_tpu_torch.tools.generate_lr_bi --gt_dir data/Vid4/GT \\
        --lr_dir data/Vid4/Bicubic4xLR --scale 4 [--up_dir data/Vid4/BI4x]

As the reference's Matlab script does, each GT sequence (read by
``data/datasets.py::_read_seq``) is modcropped to a multiple of the scale
and resized by ``ops.degrade.imresize_matlab`` on the card, in float64 as
the JAX script's numpy path computes; ``--up_dir`` also writes the LR
resized back up by the scale (clipped to [0, 1] first) for visual
comparison. Frames keep the GT names and are written as lossless PNGs by
``ops.color.save_sequence``, a ``.jpg`` name included.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from . import resolve_device
from ..data.datasets import _read_seq
from ..ops.color import float32_to_uint8, save_sequence
from ..ops.degrade import imresize_matlab
from ..utils.paths import retrieve_files


def main(argv=None, device=None):
    """``device``: None for the card; ``"cpu"`` to run on the CPU."""
    p = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.generate_lr_bi")
    p.add_argument("--gt_dir", required=True)
    p.add_argument("--lr_dir", required=True)
    p.add_argument("--up_dir", default=None)
    p.add_argument("--scale", type=int, default=4)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    s = args.scale
    for seq in sorted(os.listdir(args.gt_dir)):
        seq_dir = osp.join(args.gt_dir, seq)
        if not osp.isdir(seq_dir):
            continue
        gt = _read_seq(seq_dir, as_float=True)
        h, w = gt.shape[1] // s * s, gt.shape[2] // s * s
        gt = gt[:, :h, :w]  # modcrop
        x = torch.from_numpy(gt).to(dev, torch.float64)
        lr = imresize_matlab(x, scale=1.0 / s)
        frm_idx = [osp.basename(f) for f in retrieve_files(seq_dir)]
        save_sequence(osp.join(args.lr_dir, seq),
                      float32_to_uint8(lr.cpu().numpy()), frm_idx,
                      to_bgr=True)
        if args.up_dir:
            up = imresize_matlab(lr.clamp(0, 1), scale=float(s))
            save_sequence(osp.join(args.up_dir, seq),
                          float32_to_uint8(up.cpu().numpy()), frm_idx,
                          to_bgr=True)
        print(f"{seq}: {gt.shape} -> {tuple(lr.shape)}")


if __name__ == "__main__":
    main()
