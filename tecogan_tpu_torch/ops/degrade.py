"""BD degradation: Gaussian blur + stride-s downsampling.

Port of ``downsample_bd`` and ``bd_border_size`` from
``tecogan_tpu/ops/degrade.py``. The blur + stride conv is separable, so it
runs as two operator-matrix products on whatever device holds the frames.
"""

from __future__ import annotations

import torch

from .resize import _device_matrix, apply_separable

__all__ = ["downsample_bd", "bd_border_size"]


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
