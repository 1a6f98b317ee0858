"""Colour-space and dtype conversions and PNG sequence output.

``quantize_uint8`` is the on-device output quantisation
(``tecogan_tpu/models/networks/frnet.py`` lines 799-803). ``rgb_to_ycbcr``,
``float32_to_uint8`` and ``save_sequence`` are copied from
``tecogan_tpu/ops/color.py``; they run on the host in float64 for the
metric protocol, and ``save_sequence`` writes through ``utils/png.py``
instead of cv2.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ..utils.png import write_png

__all__ = ["quantize_uint8", "rgb_to_ycbcr", "float32_to_uint8",
           "save_sequence"]

# ITU-R BT.601 "studio swing" matrix as used by DUF-VSR / BasicSR
# (`data_utils.py:65-71`): columns produce Y, Cb, Cr from RGB in [0, 255].
_YCBCR_T = np.array(
    [
        [0.256788235294118, -0.148223529411765, 0.439215686274510],
        [0.504129411764706, -0.290992156862745, -0.367788235294118],
        [0.097905882352941, 0.439215686274510, -0.071427450980392],
    ],
    dtype=np.float64,
)
_YCBCR_O = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def quantize_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8: ``clip(round(x * 255), 0, 255)`` in fp32.

    ``torch.round`` rounds half to even, like ``jnp.round``.
    """
    return torch.clamp(torch.round(x.float() * 255.0), 0, 255).to(torch.uint8)


def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    """uint8 RGB (..., 3) -> uint8 YCbCr (..., 3)."""
    res = img.astype(np.float64) @ _YCBCR_T + _YCBCR_O
    return res.clip(0, 255).round().astype(np.uint8)


def float32_to_uint8(x: np.ndarray) -> np.ndarray:
    """float array in [0, 1] -> uint8 in [0, 255] (round-clip)."""
    return np.uint8(np.clip(np.round(x * 255.0), 0, 255))


def save_sequence(seq_dir, seq_data, frm_idx_lst=None, to_bgr=False):
    """Write a (t, h, w, c) uint8 sequence as PNG frames under ``seq_dir``.

    The pixels on disk are those the JAX package's cv2 path leaves: with
    ``to_bgr`` an RGB sequence is stored as RGB; without it the channels
    are stored in reverse, as ``cv2.imwrite`` does with an RGB array.
    """
    if not to_bgr:
        seq_data = seq_data[..., ::-1]
    if frm_idx_lst is None:
        frm_idx_lst = ["{:04d}.png".format(i) for i in range(len(seq_data))]
    os.makedirs(seq_dir, exist_ok=True)
    for i in range(len(seq_data)):
        write_png(osp.join(seq_dir, frm_idx_lst[i]), seq_data[i])
