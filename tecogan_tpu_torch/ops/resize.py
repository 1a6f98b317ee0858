"""Separable resampling as 1-D operator matrices, applied with torch matmuls.

The numpy matrix builders are copied from ``tecogan_tpu/ops/resize.py``
(lines 48-245); the port cannot import that module, which imports jax. Every
resampling the slice needs is linear and separable: an ``(out, in)`` matrix
per axis, built once on the host and applied as two matrix products over
the last two (spatial) dimensions, or, for a channels_last activation, as
two plain GEMMs over its NHWC memory (``apply_separable_nhwc``).

Modes:

- ``bilinear_half_pixel`` — ``F.interpolate(mode='bilinear',
  align_corners=False)`` (FNet's decoder, the BI upsampler).
- ``tecogan_bicubic`` — the reference's separable 4-tap cubic upsampler,
  a=-0.75, replicate padding (the BD upsampler).
- ``gauss_down`` — Gaussian blur + stride-s downsample (BD degradation),
  optionally with reflect padding.
- ``matlab_bicubic`` — Matlab ``imresize(..., 'bicubic')`` with
  antialiasing (the BI degradation).

As in the JAX package, the matrices are cast to the activation dtype at
application, so a bf16 activation is resampled by bf16 matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

__all__ = [
    "resize_matrix",
    "apply_separable",
    "apply_separable_nhwc",
    "upsample_nhwc",
    "upsample_bilinear",
    "upsample_tecogan_bicubic",
    "get_upsampling_fn",
    "upsample_mode",
    "matlab_imresize_matrix",
]


# --------------------------------------------------------------------------
# matrix builders (host-side numpy, cached)
# --------------------------------------------------------------------------

def _bilinear_half_pixel_matrix(in_size: int, scale: int) -> np.ndarray:
    """(scale*in, in) matrix for half-pixel bilinear upsampling.

    Output position o samples input coordinate (o + 0.5)/scale - 0.5 with
    indices clamped to the valid range (replicate border), which is exactly
    torch's align_corners=False behaviour.
    """
    out_size = in_size * scale
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        src = (o + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        w1 = src - i0
        m[o, np.clip(i0, 0, in_size - 1)] += 1.0 - w1
        m[o, np.clip(i0 + 1, 0, in_size - 1)] += w1
    return m.astype(np.float32)


def _bilinear_fractional_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix for half-pixel bilinear resize at an arbitrary
    (possibly fractional) ratio — torch ``nn.Upsample(scale_factor=out/in,
    mode='bilinear', align_corners=False)`` semantics (source coordinate
    (o + 0.5)/scale - 0.5, indices clamped)."""
    scale = float(out_size) / in_size
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        src = (o + 0.5) / scale - 0.5
        i0 = int(np.floor(src))
        w1 = src - i0
        m[o, np.clip(i0, 0, in_size - 1)] += 1.0 - w1
        m[o, np.clip(i0 + 1, 0, in_size - 1)] += w1
    return m.astype(np.float32)


def _cubic_weights_tecogan(s: float, a: float = -0.75) -> np.ndarray:
    """4-tap cubic weights at fractional offset s for taps [-1, 0, 1, 2]
    (Keys cubic-convolution coefficients, the reference's tap order)."""
    coeffs = np.array(
        [
            [0.0, a, -2.0 * a, a],
            [1.0, 0.0, -(a + 3.0), a + 2.0],
            [0.0, -a, 2.0 * a + 3.0, -(a + 2.0)],
            [0.0, 0.0, a, -a],
        ],
        dtype=np.float64,
    )
    powers = np.array([1.0, s, s * s, s * s * s], dtype=np.float64)
    return coeffs @ powers  # (4,) — taps [-1, 0, 1, 2]


def _tecogan_bicubic_matrix(in_size: int, scale: int) -> np.ndarray:
    """(scale*in, in) matrix reproducing the reference BicubicUpsampler.

    Output o = scale*i + d samples taps (i-1, i, i+1, i+2) with cubic
    weights at s = d/scale; borders use replicate padding (index clamping).
    """
    out_size = in_size * scale
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for d in range(scale):
        w = _cubic_weights_tecogan(d / scale)
        for i in range(in_size):
            o = scale * i + d
            for t, tap in enumerate((-1, 0, 1, 2)):
                m[o, np.clip(i + tap, 0, in_size - 1)] += w[t]
    return m.astype(np.float32)


def _gauss_1d(ksize: int, sigma: float) -> np.ndarray:
    """Symmetric Gaussian window, identical to scipy.signal.gaussian."""
    n = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    return np.exp(-(n ** 2) / (2.0 * sigma ** 2))


def _gauss_down_matrix(
    in_size: int, scale: int, sigma: float, pad: bool
) -> np.ndarray:
    """(out, in) matrix for Gaussian blur + stride-``scale`` downsampling.

    A 2-D Gaussian kernel of size 1+2*int(3*sigma), normalised over the
    full kernel, applied with stride ``scale``; the 2-D kernel is an outer
    product of this normalised 1-D window, so two 1-D passes are exact.
    With ``pad=True`` the input is reflect-padded like the inference path;
    reflected taps are folded into the matrix.
    """
    ksize = 1 + 2 * int(sigma * 3.0)
    g = _gauss_1d(ksize, sigma)
    g = g / g.sum()

    if pad:
        pad_total = ksize - 1
        pad_lo = pad_total // 2
        out_size = (in_size + pad_total - ksize) // scale + 1
    else:
        pad_lo = 0
        out_size = (in_size - ksize) // scale + 1

    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        for t in range(ksize):
            idx = o * scale + t - pad_lo
            if idx < 0:
                idx = -idx  # torch 'reflect': edge pixel not repeated
            elif idx >= in_size:
                idx = 2 * in_size - idx - 2
            m[o, idx] += g[t]
    return m.astype(np.float32)


def _matlab_cubic(x: np.ndarray) -> np.ndarray:
    """Matlab's bicubic kernel (Keys, a=-0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    w = np.where(
        ax <= 1,
        1.5 * ax3 - 2.5 * ax2 + 1.0,
        np.where(ax <= 2, -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0, 0.0),
    )
    return w


def matlab_imresize_matrix(
    in_size: int, out_size: int, antialias: bool = True,
    scale: float | None = None,
) -> np.ndarray:
    """(out, in) matrix reproducing Matlab imresize's bicubic resampling:
    half-pixel coordinate mapping, kernel widened by 1/scale when
    downscaling with antialiasing, out-of-range taps mirrored
    symmetrically. ``scale`` is the requested factor (Matlab's scale-given
    convention); it defaults to out_size/in_size."""
    if scale is None:
        scale = out_size / in_size
    if antialias and scale < 1.0:
        kernel_width = 4.0 / scale

        def kernel(x):
            return scale * _matlab_cubic(scale * x)

    else:
        kernel_width = 4.0
        kernel = _matlab_cubic

    x = np.arange(out_size, dtype=np.float64)
    u = (x + 0.5) / scale - 0.5
    left = np.floor(u - kernel_width / 2.0).astype(np.int64)
    p = int(np.ceil(kernel_width)) + 2
    taps = left[:, None] + np.arange(p)[None, :]
    weights = kernel(u[:, None] - taps)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # symmetric mirror (0-indexed: -1 -> 0, -2 -> 1, m -> m-1, ...)
    j = np.mod(taps, 2 * in_size)
    idx = np.where(j < in_size, j, 2 * in_size - 1 - j)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for o in range(out_size):
        np.add.at(m[o], idx[o], weights[o])
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def resize_matrix(mode: str, in_size: int, **kw) -> np.ndarray:
    """Cached dispatch for the 1-D operator matrices above."""
    if mode == "bilinear_half_pixel":
        return _bilinear_half_pixel_matrix(in_size, kw["scale"])
    if mode == "bilinear_fractional":
        return _bilinear_fractional_matrix(in_size, kw["out_size"])
    if mode == "tecogan_bicubic":
        return _tecogan_bicubic_matrix(in_size, kw["scale"])
    if mode == "gauss_down":
        return _gauss_down_matrix(in_size, kw["scale"], kw["sigma"], kw["pad"])
    if mode == "matlab_bicubic":
        return matlab_imresize_matrix(
            in_size, kw["out_size"], kw.get("antialias", True)
        )
    raise ValueError(f"Unrecognized resize mode: {mode}")


# --------------------------------------------------------------------------
# application
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _device_matrix(mode: str, in_size: int, dtype: torch.dtype,
                   device: torch.device, **kw) -> torch.Tensor:
    """``resize_matrix`` as a tensor on ``device`` in ``dtype``, cached so
    the streaming loop pays no host-to-device copy per frame. Made outside
    inference mode even when first asked for inside it: a cached inference
    tensor could not take part in a later training step's autograd. Made
    real even when first asked for while ``torch.export`` traces with fake
    tensors: the program then holds it as a constant on its device, and
    the cache never holds a fake tensor."""
    with torch.inference_mode(False), _disable_current_modes():
        m = torch.from_numpy(resize_matrix(mode, in_size, **kw))
        return m.to(device=device, dtype=dtype)


def apply_separable(x: torch.Tensor, mh: torch.Tensor,
                    mw: torch.Tensor) -> torch.Tensor:
    """Apply per-axis operator matrices over the last two dimensions:
    ``out[..., O, P] = sum_{h,w} mh[O, h] * mw[P, w] * x[..., h, w]``."""
    return torch.matmul(torch.matmul(mh, x), mw.transpose(0, 1))


def apply_separable_nhwc(x: torch.Tensor, mh: torch.Tensor,
                         mw: torch.Tensor) -> torch.Tensor:
    """``apply_separable`` of a channels_last (n, c, h, w) tensor, on its
    NHWC memory as two plain GEMMs with no copy: the rows over (n, h, w*c),
    then the columns over (n*H, w, c). Returns a channels_last (n, c, H,
    W). (``torch.matmul`` on the NCHW view would copy it to contiguous
    before each product.)"""
    n, c, h, w = x.shape
    big_h, big_w = mh.shape[0], mw.shape[0]
    rows = torch.matmul(mh, x.permute(0, 2, 3, 1).reshape(n, h, w * c))
    cols = torch.matmul(mw, rows.reshape(n * big_h, w, c))
    return cols.reshape(n, big_h, big_w, c).permute(0, 3, 1, 2)


def _matrices(x: torch.Tensor, mode: str, scale: int):
    h, w = x.shape[-2], x.shape[-1]
    return (_device_matrix(mode, h, x.dtype, x.device, scale=scale),
            _device_matrix(mode, w, x.dtype, x.device, scale=scale))


def _upsample(x: torch.Tensor, mode: str, scale: int) -> torch.Tensor:
    return apply_separable(x, *_matrices(x, mode, scale))


def upsample_nhwc(x: torch.Tensor, mode: str, scale: int) -> torch.Tensor:
    """x channels_last (n, c, h, w) -> channels_last (n, c, s*h, s*w) by
    the ``mode`` upsampler's matrices (``bilinear_half_pixel``,
    ``tecogan_bicubic``), on its NHWC memory."""
    return apply_separable_nhwc(x, *_matrices(x, mode, scale))


def upsample_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """x (..., h, w) -> (..., s*h, s*w), torch align_corners=False."""
    return _upsample(x, "bilinear_half_pixel", scale)


def upsample_tecogan_bicubic(x: torch.Tensor, scale: int) -> torch.Tensor:
    """x (..., h, w) -> (..., s*h, s*w), reference BicubicUpsampler."""
    return _upsample(x, "tecogan_bicubic", scale)


def upsample_mode(degradation: str) -> str:
    """The resize mode of a degradation's upsampler (reference
    `net_utils.py:85-97`)."""
    if degradation == "BI":
        return "bilinear_half_pixel"
    if degradation == "BD":
        return "tecogan_bicubic"
    raise ValueError(f"Unrecognized degradation type: {degradation}")


def get_upsampling_fn(scale: int, degradation: str):
    """Degradation-dependent upsampler."""
    return functools.partial(_upsample, mode=upsample_mode(degradation),
                             scale=scale)
