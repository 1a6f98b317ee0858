"""Degradations: BD (Gaussian blur + stride-s downsampling) and BI (Matlab
bicubic imresize).

Port of ``downsample_bd``, ``bd_border_size`` and ``imresize_matlab`` from
``tecogan_tpu/ops/degrade.py``. Both are separable, so they run as two
operator-matrix products on whatever device holds the frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .resize import _device_matrix, apply_separable, matlab_imresize_matrix

__all__ = ["downsample_bd", "bd_border_size", "imresize_matlab"]


def bd_border_size(sigma: float) -> int:
    """GT border consumed by the unpadded BD conv (`base_model.py:61`)."""
    return int(sigma * 3.0)


def downsample_bd(x: torch.Tensor, scale: int, sigma: float = 1.5,
                  pad_data: bool = False) -> torch.Tensor:
    """Gaussian blur + stride-``scale`` downsample of (..., h, w) data.

    ``pad_data=False`` is the training path (valid conv; callers crop the
    GT border by ``bd_border_size``); ``pad_data=True`` is the inference
    path with reflect padding (`base_model.py:96-119`).
    """
    h, w = x.shape[-2], x.shape[-1]
    kw = dict(scale=scale, sigma=sigma, pad=pad_data)
    mh = _device_matrix("gauss_down", h, x.dtype, x.device, **kw)
    mw = _device_matrix("gauss_down", w, x.dtype, x.device, **kw)
    return apply_separable(x, mh, mw)


@functools.lru_cache(maxsize=64)
def _imresize_mats(in_h: int, in_w: int, out_h: int, out_w: int,
                   antialias: bool, scale: float | None):
    return (
        matlab_imresize_matrix(in_h, out_h, antialias, scale=scale),
        matlab_imresize_matrix(in_w, out_w, antialias, scale=scale),
    )


def imresize_matlab(x, scale: float | None = None, out_shape=None,
                    antialias: bool = True):
    """Matlab-compatible bicubic imresize of (..., h, w, c) data, numpy or
    torch (returns the matching kind; numpy computes in float64, torch in
    the tensor's dtype on its device).

    Matlab semantics for both calling conventions: a given ``scale`` is
    used directly in the coordinate mapping (output size = ceil(in*scale));
    a given ``out_shape`` derives the per-axis scale as out/in.
    """
    h, w = x.shape[-3], x.shape[-2]
    if out_shape is None:
        out_shape = (int(np.ceil(h * scale)), int(np.ceil(w * scale)))
    else:
        scale = None
    mh, mw = _imresize_mats(h, w, out_shape[0], out_shape[1], antialias,
                            scale)
    if isinstance(x, np.ndarray):
        y = np.einsum("Oh,...hwc->...Owc", mh.astype(np.float64), x)
        return np.einsum("Pw,...Owc->...OPc", mw.astype(np.float64), y)
    mh = torch.from_numpy(mh).to(device=x.device, dtype=x.dtype)
    mw = torch.from_numpy(mw).to(device=x.device, dtype=x.dtype)
    return apply_separable(x.movedim(-1, -3), mh, mw).movedim(-3, -1)
