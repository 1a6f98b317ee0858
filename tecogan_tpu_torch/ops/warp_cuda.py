"""Bilinear backward warp of channel-major planes: the CUDA kernel and its
plain PyTorch version.

Replaces the TPU kernel ``tecogan_tpu/ops/warp_pallas.py::_warp_planes``
(kernel ``_warp_kernel``). ``out[n, ch, i, j]`` samples ``planes[n, ch]`` at
``(clip(i + fy, 0, H-1), clip(j + fx, 0, W-1))``: clamp, then floor
(grid_sample's border padding with align_corners=True). Coordinates, tap
weights and the accumulation are fp32; the output is in the planes' dtype.
The flow arrives in its producer's dtype (fp32 or bf16) and is read as
fp32. The kernel (``csrc/warp_planes.cu``) is one thread per output pixel
looping over channels; it moves about 16 B per pixel at bf16, so it is bound
by memory traffic and, at small frames, by its launch.

``warp_planes`` dispatches on where its tensors lie: CPU tensors go to
``warp_planes_reference``, CUDA tensors to the kernel. Anything else raises;
no path falls back from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["warp_planes", "warp_planes_reference"]

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def warp_planes_reference(planes: torch.Tensor,
                          flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp: planes (n, c, H, W) + flow (n, H, W, 2) ->
    (n, c, H, W) in the planes' dtype.

    Not ``F.grid_sample`` (its normalised-coordinate round trip differs in
    the last bits) and not ``tecogan_tpu/ops/warp.py::backward_warp``
    (which floors before clamping and rounds its weights to the image
    dtype): this is the TPU kernel's arithmetic, op for op as the CUDA
    kernel does it.
    """
    n, c, h, w = planes.shape
    f = flow.float()
    ii = torch.arange(h, dtype=torch.float32, device=planes.device)[:, None]
    jj = torch.arange(w, dtype=torch.float32, device=planes.device)[None, :]
    syc = torch.clamp(ii + f[..., 1], 0.0, h - 1.0)
    sxc = torch.clamp(jj + f[..., 0], 0.0, w - 1.0)
    y0 = torch.floor(syc)
    x0 = torch.floor(sxc)
    wy = syc - y0
    wx = sxc - x0
    wy0 = 1.0 - wy
    wx0 = 1.0 - wx
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)

    flat = planes.float().reshape(n, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    def wt(a, b):
        return (a * b)[:, None]

    top = wt(wx0, wy0) * tap(y0i, x0i) + wt(wx, wy0) * tap(y0i, x1i)
    bot = wt(wx0, wy) * tap(y1i, x0i) + wt(wx, wy) * tap(y1i, x1i)
    return (top + bot).to(planes.dtype)


def _check_cuda_args(planes: torch.Tensor, flow: torch.Tensor) -> None:
    if planes.device.type != "cuda" or flow.device != planes.device:
        raise ValueError(
            f"warp_planes needs both tensors on one CUDA device (or both on "
            f"the CPU); got planes on {planes.device}, flow on {flow.device}")
    if planes.dtype not in _DTYPE_TAG or flow.dtype not in _DTYPE_TAG:
        raise TypeError(f"warp_planes takes float32/bfloat16, got planes "
                        f"{planes.dtype}, flow {flow.dtype}")
    if planes.dim() != 4:
        raise ValueError(f"planes must be (n, c, H, W), got {tuple(planes.shape)}")
    n, _, h, w = planes.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f"flow must be (n, H, W, 2) = {(n, h, w, 2)}, got "
                         f"{tuple(flow.shape)}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous NCHW")


@functools.cache
def _entry_point(name: str):
    """The library's C function ``name`` with its signature declared
    (``c_void_p`` keeps 64-bit pointers and the stream intact)."""
    from ..kernel_build import load_library

    fn = getattr(load_library(), name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def warp_planes(planes: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp planes (n, c, H, W) along flow (n, H, W, 2): channel 0 is the
    horizontal displacement, channel 1 the vertical, in pixels.

    CPU tensors: ``warp_planes_reference``. CUDA tensors: the kernel,
    launched on the current stream; the flow may have any strides (e.g.
    the (n, H, W, 2) view of an NCHW flow). ``warp_planes.launches``
    counts kernel launches.
    """
    if planes.device.type == "cpu" and flow.device.type == "cpu":
        return warp_planes_reference(planes, flow)
    _check_cuda_args(planes, flow)
    name = (f"tecogan_warp_planes_{_DTYPE_TAG[planes.dtype]}_"
            f"{_DTYPE_TAG[flow.dtype]}")
    fn = _entry_point(name)
    n, c, h, w = planes.shape
    out = torch.empty_like(planes)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c, h,
                 w, *flow.stride(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    warp_planes.launches += 1
    return out


warp_planes.launches = 0
