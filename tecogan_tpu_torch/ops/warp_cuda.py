"""Bilinear backward warps: the CUDA kernels K1 and K2 and their plain
PyTorch version.

K1 (``warp_planes``) replaces the TPU kernel
``tecogan_tpu/ops/warp_pallas.py::_warp_planes`` (kernel ``_warp_kernel``),
band mode included (row-folded multi-stream inference); K2 (``warp_rgb``)
replaces ``backward_warp_rgb_flat`` (kernel ``_warp_kernel_rgb``), the
forward of every training warp. Both compute
``out[n, ch, i, j]`` = ``x[n, ch]`` sampled at ``(clip(i + fy, 0, H-1),
clip(j + fx, 0, W-1))``: clamp, then floor (grid_sample's border padding
with align_corners=True). Coordinates, tap weights and the accumulation are
fp32; the output is in the image's dtype. The flow arrives in its
producer's dtype (fp32 or bf16) and is read as fp32. K1
(``csrc/warp_planes.cu``) runs on the row tiles of ``tile_plan``: each
warp one output row, each lane ``TILE_STEPS`` pixels 32 columns apart; K2
(``csrc/warp_rgb.cu``) is one thread per output pixel. Both loop over the
channels and move about 16 B per pixel at bf16, so they are bound by
memory traffic and, at small frames, by the launch.

The wrappers dispatch on where their tensors lie: CPU tensors go to
``warp_planes_reference``, CUDA tensors to the kernel. Anything else
raises; no path falls back from a kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

__all__ = ["tile_pixels", "tile_plan", "warp_planes", "warp_planes_reference",
           "warp_rgb"]

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K1's C entry point for each (planes, flow) dtype pair
_PLANES_ENTRY = {(a, b): f"tecogan_warp_planes_{ta}_{tb}"
                 for a, ta in _DTYPE_TAG.items()
                 for b, tb in _DTYPE_TAG.items()}

# the row tiles of csrc/warp_common.cuh (kTileRows, kTileSteps)
TILE_ROWS, TILE_STEPS = 4, 2
_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y and gridDim.z
INT32_MAX = 2 ** 31 - 1


def tile_plan(images: int, rows: int, cols: int,
              lanes_per_col: int = 1) -> tuple[tuple, tuple]:
    """The (grid, block) of K1 and K5, as their C launchers compute it, for
    ``images`` x ``rows`` x ``cols`` output pixels: a block is
    ``TILE_ROWS`` warps, one row each, and each lane takes ``TILE_STEPS``
    pixels; ``lanes_per_col`` neighbouring lanes share an output column
    (K5: its s px phases), so a block spans ``32 // lanes_per_col *
    TILE_STEPS`` columns. Raises ValueError past CUDA's grid limits."""
    tile_cols = 32 // lanes_per_col * TILE_STEPS
    grid = (-(-cols // tile_cols), -(-rows // TILE_ROWS), images)
    if grid[1] > _GRID_YZ_MAX or grid[2] > _GRID_YZ_MAX:
        raise ValueError(f"{images} images of {rows} rows exceed the CUDA "
                         f"grid (at most {_GRID_YZ_MAX} images and "
                         f"{_GRID_YZ_MAX * TILE_ROWS} rows)")
    return grid, (32, TILE_ROWS)


def tile_pixels(images: int, rows: int, cols: int,
                lanes_per_col: int = 1) -> tuple:
    """Where ``tile_plan``'s launch puts each thread's pixels, by the
    kernels' index formulas: lane l of warp y of block (bx, by, bz) takes
    image bz, row by * TILE_ROWS + y and, at step k, column
    l // lanes_per_col + k * 32 // lanes_per_col of the block's tile.
    Returns numpy arrays (image, row, column, lane, block row), each indexed
    (bx, by, bz, warp, lane, step); pixels past the edge are included (the
    kernels store nothing there)."""
    (gx, gy, gz), (lanes, warps) = tile_plan(images, rows, cols,
                                             lanes_per_col)
    bx, by, bz, wy, lane, k = np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(gz), np.arange(warps),
        np.arange(lanes), np.arange(TILE_STEPS), indexing="ij")
    col_lanes = lanes // lanes_per_col
    col = bx * col_lanes * TILE_STEPS + lane // lanes_per_col + col_lanes * k
    return bz, by * TILE_ROWS + wy, col, lane, by


@functools.lru_cache(maxsize=256)
def check_warp_shapes(name: str, shape: torch.Size, flow_shape: torch.Size,
                      *more: torch.Size) -> None:
    """Raise unless the image is (n, c, H, W), the flow (n, H, W, 2) and
    every shape in ``more`` the image's. Cached: a path checks the same
    shapes every frame."""
    if len(shape) != 4:
        raise ValueError(f"{name}: the image must be (n, c, H, W), got "
                         f"{tuple(shape)}")
    n, _, h, w = shape
    if flow_shape != (n, h, w, 2):
        raise ValueError(f"{name}: flow must be (n, H, W, 2) = "
                         f"{(n, h, w, 2)}, got {tuple(flow_shape)}")
    for other in more:
        if other != shape:
            raise ValueError(f"{name}: shapes {tuple(other)} and "
                             f"{tuple(shape)} differ")


@functools.lru_cache(maxsize=256)
def _planes_plan(shape: torch.Size, flow_shape: torch.Size,
                 flow_strides: tuple, band: int, band_valid: int) -> None:
    """Raise unless K1 can take planes of ``shape`` and a flow of
    ``flow_shape`` and ``flow_strides``: the shapes of
    ``check_warp_shapes``, a valid band geometry, a grid that fits, and
    offsets that fit the kernel's 32 bits (taps within an image, flow
    values within a row). Cached: a path calls it with the same arguments
    every frame."""
    check_warp_shapes("warp_planes", shape, flow_shape)
    n, c, h, w = shape
    check_band(h, band, band_valid)
    tile_plan(n, h, w)
    if (c * h * w > INT32_MAX
            or (w - 1) * flow_strides[2] + flow_strides[3] > INT32_MAX):
        raise ValueError(f"warp_planes: an image of {c}x{h}x{w} or a flow "
                         f"with strides {flow_strides} exceeds the kernel's "
                         f"32-bit offsets")


def bilinear_taps(flow: torch.Tensor, h: int, w: int, band: int = 0,
                  band_valid: int = 0):
    """The fp32 stencil of every output pixel for an (n, H, W, 2) flow:
    int64 tap indices (y0, x0, y1, x1) and fractional weights (wy, wx),
    each (n, H, W), in the kernels' order of operations. ``band`` > 0
    takes each row relative to its band of ``band`` rows and clamps it to
    the band's first ``band_valid`` rows (K1's band mode)."""
    f = flow.float()
    rows = torch.arange(h, device=flow.device)[:, None]
    first, rows_valid = 0, h
    if band:
        first, rows, rows_valid = rows - rows % band, rows % band, band_valid
    ii = rows.float()
    jj = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    syc = torch.clamp(ii + f[..., 1], 0.0, rows_valid - 1.0)
    sxc = torch.clamp(jj + f[..., 0], 0.0, w - 1.0)
    y0 = torch.floor(syc)
    x0 = torch.floor(sxc)
    y0i = y0.long()
    x0i = x0.long()
    return (first + y0i, x0i, first + torch.clamp(y0i + 1, max=rows_valid - 1),
            torch.clamp(x0i + 1, max=w - 1), syc - y0, sxc - x0)


def gather_tap(img: torch.Tensor, yi: torch.Tensor,
               xi: torch.Tensor) -> torch.Tensor:
    """The values of img (n, c, H, W) at the (n, H, W) tap indices."""
    n, c, h, w = img.shape
    idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
    return img.reshape(n, c, h * w).gather(2, idx).reshape(n, c, h, w)


def warp_planes_reference(planes: torch.Tensor, flow: torch.Tensor,
                          band: int = 0, band_valid: int = 0) -> torch.Tensor:
    """Plain PyTorch warp: planes (n, c, H, W), any strides, + flow
    (n, H, W, 2) -> (n, c, H, W) in the planes' dtype. The plain version of
    both K1 and K2, and of K1's band mode (``band`` > 0: the rows are
    H / band independent bands, each clamped to its first ``band_valid``
    rows; see ``warp_planes``).

    Not ``F.grid_sample`` (its normalised-coordinate round trip differs in
    the last bits) and not ``tecogan_tpu/ops/warp.py::backward_warp``
    (which floors before clamping and rounds its weights to the image
    dtype): this is the TPU kernels' arithmetic, op for op as the CUDA
    kernels do it.
    """
    h, w = planes.shape[-2:]
    check_band(h, band, band_valid)
    y0i, x0i, y1i, x1i, wy, wx = bilinear_taps(flow, h, w, band, band_valid)
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


def check_band(h: int, band: int, band_valid: int) -> None:
    """Raise unless band = 0, or band divides h and 0 < band_valid <= band."""
    if band and (band < 0 or h % band or not 0 < band_valid <= band):
        raise ValueError(f"band mode needs H % band == 0 and 0 < band_valid "
                         f"<= band; got H={h}, band={band}, "
                         f"band_valid={band_valid}")


def all_on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def cuda_index(name: str, *tensors: torch.Tensor) -> int:
    """The index of the one CUDA device all ``tensors`` lie on; raise
    ValueError unless there is one."""
    index = tensors[0].get_device()
    if not tensors[0].is_cuda or any(t.get_device() != index
                                     for t in tensors[1:]):
        devs = [t.device for t in tensors]
        raise ValueError(
            f"{name} needs all tensors on one CUDA device (or all on the "
            f"CPU); got {', '.join(map(str, devs))}")
    return index


def check_cuda_warp_args(name: str, img: torch.Tensor, flow: torch.Tensor,
                         *more: torch.Tensor) -> int:
    """Raise unless every tensor lies on one CUDA device in f32/bf16 and
    their shapes pass ``check_warp_shapes``; return the device's index."""
    index = cuda_index(name, img, flow, *more)
    if (img.dtype not in _DTYPE_TAG or flow.dtype not in _DTYPE_TAG
            or any(t.dtype not in _DTYPE_TAG for t in more)):
        dts = [t.dtype for t in (img, flow, *more)]
        raise TypeError(f"{name} takes float32/bfloat16, got {dts}")
    check_warp_shapes(name, img.shape, flow.shape, *(t.shape for t in more))
    return index


@functools.cache
def _entry_point(name: str):
    """The library's C function ``name``: it takes one int64 array of
    arguments and returns a CUDA error code."""
    from ..kernel_build import load_library

    fn = getattr(load_library(), name)
    fn.argtypes = (ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    return fn


_ARGS = threading.local()


def launch(name: str, index: int, *args: int) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of CUDA device ``index`` packed in one int64 array (this thread's,
    reused call to call: the entry point reads it before it returns), with
    that device current; raise if it reports a CUDA error."""
    buf = getattr(_ARGS, "buf", None)
    if buf is None:
        buf = _ARGS.buf = (ctypes.c_int64 * 32)()
    buf[:len(args)] = args
    # the stream's handle, without building a torch.cuda.Stream
    buf[len(args)] = torch._C._cuda_getCurrentRawStream(index)
    fn = _entry_point(name)
    if index == torch.cuda.current_device():
        err = fn(ctypes.addressof(buf))
    else:
        with torch.cuda.device(index):
            err = fn(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def warp_planes(planes: torch.Tensor, flow: torch.Tensor, band: int = 0,
                band_valid: int = 0) -> torch.Tensor:
    """Warp planes (n, c, H, W) along flow (n, H, W, 2): channel 0 is the
    horizontal displacement, channel 1 the vertical, in pixels.

    ``band`` > 0 is the row-folded multi-stream mode (the TPU kernel's
    ``band``/``band_valid``): the H rows are H / band streams of ``band``
    rows, of which the first ``band_valid`` are valid; row i samples at
    ``clip(i mod band + fy, 0, band_valid - 1)`` within its own band. H must
    be a multiple of ``band``.

    CPU tensors: ``warp_planes_reference``. CUDA tensors: K1, launched on
    the current stream; the planes are contiguous NCHW, the flow may have
    any strides (e.g. the (n, H, W, 2) view of an NCHW flow).
    ``warp_planes.launches`` counts kernel launches, and
    ``warp_planes.band_launches`` those of them in band mode.
    """
    if not planes.is_cuda and all_on_cpu(planes, flow):
        return warp_planes_reference(planes, flow, band, band_valid)
    index = cuda_index("warp_planes", planes, flow)
    name = _PLANES_ENTRY.get((planes.dtype, flow.dtype))
    if name is None:
        raise TypeError(f"warp_planes takes float32/bfloat16, got "
                        f"{[planes.dtype, flow.dtype]}")
    fs = flow.stride()
    _planes_plan(planes.shape, flow.shape, fs, band, band_valid)
    if not planes.is_contiguous():
        raise ValueError("warp_planes: planes must be contiguous NCHW")
    n, c, h, w = planes.shape
    out = torch.empty_like(planes)
    launch(name, index, planes.data_ptr(), flow.data_ptr(), out.data_ptr(),
           n, c, h, w, band, band_valid, *fs)
    warp_planes.launches += 1
    warp_planes.band_launches += bool(band)
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
    index = check_cuda_warp_args("warp_rgb", x, flow)
    name = f"tecogan_warp_rgb_{_DTYPE_TAG[x.dtype]}_{_DTYPE_TAG[flow.dtype]}"
    n, c, h, w = x.shape
    out = torch.empty_like(x)
    launch(name, index, x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c,
           h, w, *x.stride(), *out.stride(), *flow.stride())
    warp_rgb.launches += 1
    return out


warp_planes.launches = 0
warp_planes.band_launches = 0
warp_rgb.launches = 0
