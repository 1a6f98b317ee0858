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
the output is in the planes' dtype. The kernel is one thread per output
pixel and phase looping over channels, bound by memory traffic.

The wrapper dispatches on where its tensors lie: CPU tensors go to
``warp_phases_reference``, CUDA tensors to the kernel. Anything else
raises; no path falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .warp_cuda import _DTYPE_TAG, all_on_cpu, launch, strides_arg

__all__ = ["phase_planes", "warp_phases", "warp_phases_reference"]

# the TPU kernel's halo: displacements up to s * (48 - 2) HR pixels
HALO_BOUND = 46
# (planes, sy, sx, out, n, s, c, h, w, strides[14], stream)
_PHASES_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                    + (ctypes.c_void_p,) * 2)


def phase_planes(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """The phase planes of an HR frame (n, c, s*h, s*w) as a view
    (n, s, s, c, h, w), indexed (n, py, px, c, i, j); no copy."""
    n, c, hh, ww = hr.shape
    return hr.unflatten(2, (hh // scale, scale)).unflatten(
        4, (ww // scale, scale)).permute(0, 3, 5, 1, 2, 4)


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
        if tuple(t.shape) != (n, s * s, h, w):
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

    CPU tensors: ``warp_phases_reference``. CUDA tensors: K5, launched on
    the current stream; the planes (f32 or bf16) are read through their
    element strides, so ``phase_planes(hr, s)`` of a contiguous HR frame
    needs no copy; the coordinates are f32, any strides.
    ``warp_phases.launches`` counts kernel launches.
    """
    if all_on_cpu(planes, sy, sx):
        return warp_phases_reference(planes, sy, sx, scale)
    devs = [t.device for t in (planes, sy, sx)]
    if devs[0].type != "cuda" or any(d != devs[0] for d in devs):
        raise ValueError(
            f"warp_phases needs all tensors on one CUDA device (or all on "
            f"the CPU); got {', '.join(map(str, devs))}")
    if planes.dtype not in _DTYPE_TAG:
        raise TypeError(f"warp_phases: planes must be float32/bfloat16, got "
                        f"{planes.dtype}")
    if sy.dtype != torch.float32 or sx.dtype != torch.float32:
        raise TypeError(f"warp_phases: coordinates must be float32, got "
                        f"{sy.dtype}, {sx.dtype}")
    p = _planes6(planes, scale)
    _check_coords(p, sy, sx)
    n, s, _, c, h, w = p.shape
    out = torch.empty((n, s * s, c, h, w), dtype=planes.dtype,
                      device=planes.device)
    launch(f"tecogan_warp_phases_{_DTYPE_TAG[planes.dtype]}",
           _PHASES_ARGTYPES, planes.device, p.data_ptr(), sy.data_ptr(),
           sx.data_ptr(), out.data_ptr(), n, s, c, h, w,
           strides_arg(p, sy, sx))
    warp_phases.launches += 1
    return out.transpose(1, 2)


warp_phases.launches = 0
