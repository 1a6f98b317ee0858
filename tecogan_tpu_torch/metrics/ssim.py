"""SSIM (structural similarity), matching skimage's compare_ssim defaults
(copied from ``tecogan_tpu/metrics/ssim.py``).

The reference's official metric stack calls
``skimage.measure.compare_ssim(Y_true, Y_pred, data_range=...)``
(`official_metrics/metrics.py:74-75`), whose defaults are: uniform 7x7
window, K1=0.01, K2=0.03, sample covariance normalisation (N/(N-1)), and
mean over the valid (centre-cropped by win//2) region. skimage is not
available in this environment, so this is a from-scratch implementation of
the same estimator (Wang et al. 2004).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["ssim"]


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    if min(img1.shape[0], img1.shape[1]) < win_size:
        # the centre crop below would be empty -> NaN with only a numpy
        # warning; skimage raises here too
        raise ValueError(
            f"win_size {win_size} exceeds image extent "
            f"{img1.shape[0]}x{img1.shape[1]}")
    x = img1.astype(np.float64)
    y = img2.astype(np.float64)

    filt = lambda a: ndimage.uniform_filter(a, size=win_size)
    n = win_size ** 2
    cov_norm = n / (n - 1.0)  # sample covariance

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    return float(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())
