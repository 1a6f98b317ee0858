"""Bilinear backward warp of an HR frame's phase planes: the CUDA kernel K5
and its plain PyTorch version.

K5 (``warp_phases``, ``csrc/warp_phases.cu``) replaces the TPU kernel
``tecogan_tpu/ops/warp_pallas.py::backward_warp_packed_planes`` (kernel
``_warp_kernel_phases``), the warp of the ``FRNetConfig.packed16``
streaming recurrence. An HR frame of s*h x s*w pixels is held as s*s phase
planes: plane q = py*s + px holds HR pixels (s*i + py, s*j + px). Output
phase q at (i, j) samples the HR frame at absolute coordinates
``(sy, sx)[q, i, j]``, first clamped to within s*46 HR pixels of
(s*i, s*j) (the TPU kernel's halo bound); a tap outside the HR frame reads
0. Coordinates, weights and sums are fp32, added in the TPU kernel's order;
the output is in the planes' dtype. The kernel is built for s = 2 and 4
and runs on ``warp_cuda.tile_plan``'s row tiles with the s px phases of an
output column on neighbouring lanes, so a warp reads 32 neighbouring HR
columns; it loops over channels and is bound by memory traffic.

The wrapper dispatches on where its tensors lie: CPU tensors go to
``warp_phases_reference``, CUDA tensors to the kernel. Anything else
raises; no path falls back from the kernel to the plain version. K5 is the
PyTorch operator ``tecogan_torch::warp_phases`` (CUDA: the kernel; CPU:
the plain version; fake: the output's size and strides), so a
``packed16`` serving program calls the kernel the live path calls.
"""

from __future__ import annotations

import functools

import torch

from .warp_cuda import (INT32_MAX, OPS, _DTYPE_TAG, cuda_index, launch,
                        require_fake, tile_plan)

__all__ = ["phase_planes", "warp_phases", "warp_phases_reference"]

# the TPU kernel's halo: displacements up to s * (48 - 2) HR pixels
HALO_BOUND = 46
# the scales K5 is built for (a template parameter of the kernel)
KERNEL_SCALES = (2, 4)
_PHASES_ENTRY = {d: f"tecogan_warp_phases_{t}" for d, t in _DTYPE_TAG.items()}


def phase_planes(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """The phase planes of an HR frame (n, c, s*h, s*w) as a view
    (n, s, s, c, h, w), indexed (n, py, px, c, i, j); no copy."""
    n, c, hh, ww = hr.shape
    if hh % scale or ww % scale:
        raise ValueError(f"an HR frame of {hh}x{ww} has no phase planes at "
                         f"scale {scale}")
    sn, sc, sh, sw = hr.stride()
    return hr.as_strided(
        (n, scale, scale, c, hh // scale, ww // scale),
        (sn, sh, sw, sc, scale * sh, scale * sw), hr.storage_offset())


def _planes6(planes: torch.Tensor, scale: int) -> torch.Tensor:
    """(n, s*s, c, h, w) or (n, s, s, c, h, w) planes as the latter."""
    if planes.dim() == 5 and planes.shape[1] == scale * scale:
        return planes.unflatten(1, (scale, scale))
    if planes.dim() == 6 and planes.shape[1:3] == (scale, scale):
        return planes
    raise ValueError(f"planes must be (n, s*s, c, h, w) or (n, s, s, c, h, "
                     f"w) for s={scale}; got {tuple(planes.shape)}")


def _check_coords(planes6: torch.Tensor, sy: torch.Tensor,
                  sx: torch.Tensor) -> None:
    n, s, _, _, h, w = planes6.shape
    for t in (sy, sx):
        if t.shape != (n, s * s, h, w):
            raise ValueError(f"coordinates must be (n, s*s, h, w) = "
                             f"{(n, s * s, h, w)}, got {tuple(t.shape)}")


def warp_phases_reference(planes: torch.Tensor, sy: torch.Tensor,
                          sx: torch.Tensor, scale: int) -> torch.Tensor:
    """Plain PyTorch K5: planes (n, s*s, c, h, w) or their (n, s, s, c, h, w)
    view, any strides; sy, sx (n, s*s, h, w) absolute HR coordinates ->
    warped phase planes (n, c, s*s, h, w) in the planes' dtype, as a view of
    a contiguous (n, s*s, c, h, w) tensor (conv_in's space_to_depth order).

    The TPU kernel's arithmetic, op for op as the CUDA kernel does it: the
    halo clamp, clamp-then-floor, taps outside the HR frame read 0, and the
    four ``(w_y * w_x) * v`` terms added in the order (y0, x0), (y0, x1),
    (y1, x0), (y1, x1).
    """
    p = _planes6(planes, scale)
    _check_coords(p, sy, sx)
    n, s, _, c, h, w = p.shape
    hh, ww = s * h, s * w
    dev = planes.device
    # (n, py, px, c, i, j) -> the HR frame (n, c, i, py, j, px)
    hr = p.float().permute(0, 3, 4, 1, 5, 2).reshape(n, c, hh * ww)
    row = (s * torch.arange(h, device=dev)).float()[:, None]
    col = (s * torch.arange(w, device=dev)).float()[None, :]
    bound = float(s * HALO_BOUND)
    syc = torch.clamp(sy.float(), row - bound, row + bound)
    sxc = torch.clamp(sx.float(), col - bound, col + bound)
    y0 = torch.floor(syc)
    x0 = torch.floor(sxc)
    wy = syc - y0
    wx = sxc - x0
    y0i = y0.long()
    x0i = x0.long()
    acc = None
    for dy, w_y in ((0, 1.0 - wy), (1, wy)):
        for dx, w_x in ((0, 1.0 - wx), (1, wx)):
            yi, xi = y0i + dy, x0i + dx
            inside = (yi >= 0) & (yi < hh) & (xi >= 0) & (xi < ww)
            idx = yi.clamp(0, hh - 1) * ww + xi.clamp(0, ww - 1)
            v = hr.gather(2, idx.reshape(n, 1, -1).expand(n, c, -1))
            v = torch.where(inside.reshape(n, 1, -1), v, 0.0)
            term = (w_y * w_x).reshape(n, 1, -1) * v
            acc = term if acc is None else acc + term
    out = acc.reshape(n, c, s * s, h, w).to(planes.dtype)
    return out.transpose(1, 2).contiguous().transpose(1, 2)


def warp_phases(planes: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                scale: int) -> torch.Tensor:
    """Warp an HR frame's phase planes to the absolute HR coordinates
    ``(sy, sx)`` of each output phase; shapes and result as
    ``warp_phases_reference``.

    Calls the operator ``tecogan_torch::warp_phases``. CPU tensors:
    ``warp_phases_reference``. CUDA tensors: K5 (``scale`` 2 or 4),
    launched on the current stream; the planes (f32 or bf16) are read
    through their element strides, so ``phase_planes(hr, s)`` of a
    contiguous HR frame needs no copy; the coordinates are f32, any
    strides. Other devices raise.
    ``warp_phases.launches`` counts kernel launches.
    """
    return _PHASES_OP(planes, sy, sx, scale)


def _warp_phases_cuda(planes: torch.Tensor, sy: torch.Tensor,
                      sx: torch.Tensor, scale: int) -> torch.Tensor:
    """The operator's CUDA implementation: checks, then one K5 launch."""
    index = cuda_index("warp_phases", planes, sy, sx)
    name = _PHASES_ENTRY.get(planes.dtype)
    if name is None:
        raise TypeError(f"warp_phases: planes must be float32/bfloat16, got "
                        f"{planes.dtype}")
    if sy.dtype != torch.float32 or sx.dtype != torch.float32:
        raise TypeError(f"warp_phases: coordinates must be float32, got "
                        f"{sy.dtype}, {sx.dtype}")
    args, size, stride = _phases_plan(scale, planes.shape, planes.stride(),
                                      sy.shape, sy.stride(), sx.shape,
                                      sx.stride())
    out = torch.empty_strided(size, stride, dtype=planes.dtype,
                              device=planes.device)
    launch(name, index, planes.data_ptr(), sy.data_ptr(), sx.data_ptr(),
           out.data_ptr(), *args)
    warp_phases.launches += 1
    return out


def _warp_phases_fake(planes: torch.Tensor, sy: torch.Tensor,
                      sx: torch.Tensor, scale: int) -> torch.Tensor:
    require_fake("warp_phases", planes, sy, sx)
    p = _planes6(planes, scale)
    _check_coords(p, sy, sx)
    n, s, _, c, h, w = p.shape
    chw = c * h * w
    return planes.new_empty_strided((n, c, s * s, h, w),
                                    (s * s * chw, h * w, chw, w, 1))


@functools.lru_cache(maxsize=256)
def _phases_plan(scale: int, shape: torch.Size, strides: tuple,
                 y_shape: torch.Size, y_strides: tuple, x_shape: torch.Size,
                 x_strides: tuple) -> tuple:
    """K5's launch for planes of ``shape`` and element ``strides``
    ((n, s*s, c, h, w) or (n, s, s, c, h, w)) and coordinates of the given
    shapes and strides: (the kernel's integer arguments after the four
    pointers, the output's size, its strides). The output is a contiguous
    (n, s*s, c, h, w) tensor viewed as (n, c, s*s, h, w). Raises unless the
    kernel is built for ``scale``, the shapes agree, the grid fits and
    offsets fit the kernel's 32 bits (taps within an image, coordinates
    within a row). Cached: a path calls it with the same arguments every
    frame."""
    if scale not in KERNEL_SCALES:
        raise ValueError(f"warp_phases: the kernel is built for scales "
                         f"{KERNEL_SCALES}, got {scale}")
    s = scale
    if len(shape) == 5 and shape[1] == s * s:
        n, _, c, h, w = shape
        sn, sq, sc, si, sj = strides
        strides = (sn, s * sq, sq, sc, si, sj)
    elif len(shape) == 6 and shape[1:3] == (s, s):
        n, _, _, c, h, w = shape
    else:
        raise ValueError(f"planes must be (n, s*s, c, h, w) or (n, s, s, c, "
                         f"h, w) for s={s}; got {tuple(shape)}")
    for t in (y_shape, x_shape):
        if t != (n, s * s, h, w):
            raise ValueError(f"coordinates must be (n, s*s, h, w) = "
                             f"{(n, s * s, h, w)}, got {tuple(t)}")
    tile_plan(n * s, h, w, lanes_per_col=s)
    _, spy, spx, sc, si, sj = strides
    last = ((s - 1) * spy + (s - 1) * spx + (c - 1) * sc + (h - 1) * si
            + (w - 1) * sj)
    if max(last, (w - 1) * y_strides[3], (w - 1) * x_strides[3]) > INT32_MAX:
        raise ValueError(f"warp_phases: planes {tuple(shape)} with strides "
                         f"{strides}, or coordinates with strides "
                         f"{y_strides}, {x_strides}, exceed the kernel's "
                         f"32-bit offsets")
    args = (n, s, c, h, w, *strides, *y_strides, *x_strides)
    chw = c * h * w
    return args, (n, c, s * s, h, w), (s * s * chw, h * w, chw, w, 1)


OPS.define("warp_phases(Tensor planes, Tensor sy, Tensor sx, int scale) "
           "-> Tensor")
OPS.impl("warp_phases", _warp_phases_cuda, "CUDA")
OPS.impl("warp_phases", warp_phases_reference, "CPU")
torch.library.register_fake("tecogan_torch::warp_phases", _warp_phases_fake,
                            lib=OPS)
_PHASES_OP = torch.ops.tecogan_torch.warp_phases.default
warp_phases.launches = 0
