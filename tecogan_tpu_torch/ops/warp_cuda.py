"""Bilinear backward warps: the CUDA kernels K1 and K2 and their plain
PyTorch version.

K1 (``warp_planes``) replaces the TPU kernel
``tecogan_tpu/ops/warp_pallas.py::_warp_planes`` (kernel ``_warp_kernel``);
K2 (``warp_rgb``) replaces ``backward_warp_rgb_flat`` (kernel
``_warp_kernel_rgb``), the forward of every training warp. Both compute
``out[n, ch, i, j]`` = ``x[n, ch]`` sampled at ``(clip(i + fy, 0, H-1),
clip(j + fx, 0, W-1))``: clamp, then floor (grid_sample's border padding
with align_corners=True). Coordinates, tap weights and the accumulation are
fp32; the output is in the image's dtype. The flow arrives in its
producer's dtype (fp32 or bf16) and is read as fp32. Each kernel
(``csrc/warp_planes.cu``, ``csrc/warp_rgb.cu``) is one thread per output
pixel looping over channels; they move about 16 B per pixel at bf16, so
they are bound by memory traffic and, at small frames, by the launch.

The wrappers dispatch on where their tensors lie: CPU tensors go to
``warp_planes_reference``, CUDA tensors to the kernel. Anything else
raises; no path falls back from a kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["warp_planes", "warp_planes_reference", "warp_rgb"]

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PLANES_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
                    + (ctypes.c_int64,) * 4 + (ctypes.c_void_p,))
# (x, flow, out, n, c, H, W, strides[12], stream)
_RGB_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
                 + (ctypes.c_void_p,) * 2)


def bilinear_taps(flow: torch.Tensor, h: int, w: int):
    """The fp32 stencil of every output pixel for an (n, H, W, 2) flow:
    int64 tap indices (y0, x0, y1, x1) and fractional weights (wy, wx),
    each (n, H, W), in the kernels' order of operations."""
    f = flow.float()
    ii = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    jj = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    syc = torch.clamp(ii + f[..., 1], 0.0, h - 1.0)
    sxc = torch.clamp(jj + f[..., 0], 0.0, w - 1.0)
    y0 = torch.floor(syc)
    x0 = torch.floor(sxc)
    y0i = y0.long()
    x0i = x0.long()
    return (y0i, x0i, torch.clamp(y0i + 1, max=h - 1),
            torch.clamp(x0i + 1, max=w - 1), syc - y0, sxc - x0)


def gather_tap(img: torch.Tensor, yi: torch.Tensor,
               xi: torch.Tensor) -> torch.Tensor:
    """The values of img (n, c, H, W) at the (n, H, W) tap indices."""
    n, c, h, w = img.shape
    idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
    return img.reshape(n, c, h * w).gather(2, idx).reshape(n, c, h, w)


def warp_planes_reference(planes: torch.Tensor,
                          flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch warp: planes (n, c, H, W), any strides, + flow
    (n, H, W, 2) -> (n, c, H, W) in the planes' dtype. The plain version of
    both K1 and K2.

    Not ``F.grid_sample`` (its normalised-coordinate round trip differs in
    the last bits) and not ``tecogan_tpu/ops/warp.py::backward_warp``
    (which floors before clamping and rounds its weights to the image
    dtype): this is the TPU kernels' arithmetic, op for op as the CUDA
    kernels do it.
    """
    h, w = planes.shape[-2:]
    y0i, x0i, y1i, x1i, wy, wx = bilinear_taps(flow, h, w)
    wy0 = 1.0 - wy
    wx0 = 1.0 - wx
    xf = planes.float()

    def tap(yi, xi):
        return gather_tap(xf, yi, xi)

    def wt(a, b):
        return (a * b)[:, None]

    top = wt(wx0, wy0) * tap(y0i, x0i) + wt(wx, wy0) * tap(y0i, x1i)
    bot = wt(wx0, wy) * tap(y1i, x0i) + wt(wx, wy) * tap(y1i, x1i)
    return (top + bot).to(planes.dtype)


def all_on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda_warp_args(name: str, img: torch.Tensor, flow: torch.Tensor,
                         *more: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device in f32/bf16, the
    image is (n, c, H, W), the flow (n, H, W, 2) and ``more`` the image's
    shape."""
    devs = [t.device for t in (img, flow, *more)]
    if devs[0].type != "cuda" or any(d != devs[0] for d in devs):
        raise ValueError(
            f"{name} needs all tensors on one CUDA device (or all on the "
            f"CPU); got {', '.join(map(str, devs))}")
    dts = [t.dtype for t in (img, flow, *more)]
    if any(d not in _DTYPE_TAG for d in dts):
        raise TypeError(f"{name} takes float32/bfloat16, got {dts}")
    if img.dim() != 4:
        raise ValueError(f"{name}: the image must be (n, c, H, W), got "
                         f"{tuple(img.shape)}")
    n, _, h, w = img.shape
    if tuple(flow.shape) != (n, h, w, 2):
        raise ValueError(f"{name}: flow must be (n, H, W, 2) = "
                         f"{(n, h, w, 2)}, got {tuple(flow.shape)}")
    for t in more:
        if t.shape != img.shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(img.shape)} differ")


@functools.cache
def _entry_point(name: str, argtypes: tuple):
    """The library's C function ``name`` with its signature declared
    (``c_void_p`` keeps 64-bit pointers and the stream intact)."""
    from ..kernel_build import load_library

    fn = getattr(load_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` on ``device``'s current stream; raise
    if it reports a CUDA error."""
    fn = _entry_point(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def strides_arg(*tensors: torch.Tensor):
    """The tensors' element strides, concatenated, as a C int64 array."""
    vals = [s for t in tensors for s in t.stride()]
    return (ctypes.c_int64 * len(vals))(*vals)


def warp_planes(planes: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp planes (n, c, H, W) along flow (n, H, W, 2): channel 0 is the
    horizontal displacement, channel 1 the vertical, in pixels.

    CPU tensors: ``warp_planes_reference``. CUDA tensors: K1, launched on
    the current stream; the planes are contiguous NCHW, the flow may have
    any strides (e.g. the (n, H, W, 2) view of an NCHW flow).
    ``warp_planes.launches`` counts kernel launches.
    """
    if all_on_cpu(planes, flow):
        return warp_planes_reference(planes, flow)
    check_cuda_warp_args("warp_planes", planes, flow)
    if not planes.is_contiguous():
        raise ValueError("warp_planes: planes must be contiguous NCHW")
    name = (f"tecogan_warp_planes_{_DTYPE_TAG[planes.dtype]}_"
            f"{_DTYPE_TAG[flow.dtype]}")
    n, c, h, w = planes.shape
    out = torch.empty_like(planes)
    launch(name, _PLANES_ARGTYPES, planes.device, planes.data_ptr(),
           flow.data_ptr(), out.data_ptr(), n, c, h, w, *flow.stride())
    warp_planes.launches += 1
    return out


def warp_rgb(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp an image x, logically (n, c, H, W), along flow (n, H, W, 2).

    CPU tensors: ``warp_planes_reference``. CUDA tensors: K2, launched on
    the current stream. The image and the flow are read through their
    element strides, so an NCHW tensor and a channels_last one both work
    without a copy; the output is ``torch.empty_like(x)``, in x's memory
    format. ``warp_rgb.launches`` counts kernel launches.
    """
    if all_on_cpu(x, flow):
        return warp_planes_reference(x, flow)
    check_cuda_warp_args("warp_rgb", x, flow)
    name = f"tecogan_warp_rgb_{_DTYPE_TAG[x.dtype]}_{_DTYPE_TAG[flow.dtype]}"
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    launch(name, _RGB_ARGTYPES, x.device, x.data_ptr(), flow.data_ptr(),
           out.data_ptr(), n, c, h, w, strides_arg(x, out, flow))
    warp_rgb.launches += 1
    return out


warp_planes.launches = 0
warp_rgb.launches = 0
