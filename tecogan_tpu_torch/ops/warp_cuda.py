"""Bilinear backward warps: the CUDA kernels K1 and K2 and their plain
PyTorch version.

K1 (``warp_planes``) replaces the TPU kernel
``tecogan_tpu/ops/warp_pallas.py::_warp_planes`` (kernel ``_warp_kernel``),
band mode included (row-folded multi-stream inference), and its window
mode (``warp_planes_window``, row-sharded inference: a slab of a taller
image, clamped at the global border as
``tecogan_tpu/ops/warp.py::backward_warp_window``); K2 (``warp_rgb``)
replaces ``backward_warp_rgb_flat`` (kernel ``_warp_kernel_rgb``), the
forward of every training warp. Both compute
``out[n, ch, i, j]`` = ``x[n, ch]`` sampled at ``(clip(i + fy, 0, H-1),
clip(j + fx, 0, W-1))``: clamp, then floor (grid_sample's border padding
with align_corners=True). Coordinates, tap weights and the accumulation are
fp32; the output is in the image's dtype. The flow arrives in its
producer's dtype (fp32 or bf16) and is read as fp32. One kernel body
(``csrc/warp_planes.cu``) serves both, on the row tiles of ``tile_plan``:
each warp one output row, each lane ``TILE_STEPS`` pixels 32 columns
apart, the RGB channel count unrolled so every tap load is in flight
before the first is used, 32-bit offsets within an image. K1 reads
contiguous planes; K2 reads the image and writes the output through their
element strides (NCHW or channels_last, no copy). Both move about 16 B per
pixel at bf16, so they are bound by memory traffic and, at the training
warps' small frames, by the launch.

The wrappers dispatch on where their tensors lie: CPU tensors go to
``warp_planes_reference``, CUDA tensors to the kernel. Anything else
raises; no path falls back from a kernel to the plain version. K1 is the
PyTorch operator ``tecogan_torch::warp_planes`` (``OPS``): its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, and its fake implementation gives the output's shape, dtype and
strides, so that ``torch.export`` traces through it and a loaded serving
program calls the same kernel as the live path. The operator is
registered through ``torch.library.Library`` rather than ``custom_op``,
which adds a Python dispatch layer of its own to every call.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["OPS", "stride_grid", "tile_pixels", "tile_plan", "warp_planes",
           "warp_planes_reference", "warp_planes_window",
           "warp_planes_window_reference", "warp_rgb", "warp_zero",
           "warp_zero_reference", "zero_taps"]

# the port's operators (K1 here, K5 in warp_phases.py)
OPS = torch.library.Library("tecogan_torch", "DEF")

_DTYPE_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K1's C entry point for each (planes, flow) dtype pair, and its window
# mode's
_PLANES_ENTRY = {(a, b): f"tecogan_warp_planes_{ta}_{tb}"
                 for a, ta in _DTYPE_TAG.items()
                 for b, tb in _DTYPE_TAG.items()}
_WINDOW_ENTRY = {k: v.replace("_planes_", "_window_")
                 for k, v in _PLANES_ENTRY.items()}

# the row tiles of csrc/warp_common.cuh (kTileRows, kTileSteps)
TILE_ROWS, TILE_STEPS = 4, 2
# output elements a thread of K3 converts at once (csrc/warp_vjp.cu kUnroll)
CONVERT_UNROLL = 4
_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y and gridDim.z
INT32_MAX = 2 ** 31 - 1


def tile_plan(images: int, rows: int, cols: int, lanes_per_col: int = 1,
              steps: int = TILE_STEPS) -> tuple[tuple, tuple]:
    """The (grid, block) of K1, K2 and K5, as their C launchers compute it, for
    ``images`` x ``rows`` x ``cols`` output pixels: a block is
    ``TILE_ROWS`` warps, one row each, and each lane takes ``steps``
    pixels (K3's tiles: 1); ``lanes_per_col`` neighbouring lanes share an
    output column (K5: its s px phases), so a block spans ``32 //
    lanes_per_col * steps`` columns. Raises ValueError past CUDA's grid
    limits."""
    tile_cols = 32 // lanes_per_col * steps
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


def stride_grid(images: int, channels: int, rows: int, cols: int,
                cap: int) -> tuple[int, int, int]:
    """K3's cooperative grid, as its C launcher computes it: ``tile_plan``'s
    (column tiles, row tiles, images) of one pixel a lane, with more row
    blocks where that is
    fewer than the blocks that convert ``CONVERT_UNROLL`` output elements a
    thread, capped to at most ``cap`` blocks (the blocks that fit on the
    card at once): columns first, then images, then rows. Each block walks
    the tiles, and its threads the elements, with grid-stride loops."""
    (gx, gy, gz), (lanes, warps) = tile_plan(images, rows, cols, steps=1)
    block = lanes * warps * CONVERT_UNROLL
    convert = -(-images * channels * rows * cols // block)
    x = min(gx, cap)
    z = min(gz, cap // x)
    return x, min(max(gy, -(-convert // (x * z))), cap // (x * z)), z


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
def check_offsets(name: str, shape: torch.Size, flow_strides: tuple,
                  *image_strides: tuple) -> None:
    """Raise unless the offsets a kernel keeps in 32 bits fit: within an
    image of ``shape`` (n, c, H, W) laid out by each of ``image_strides``,
    and within a row of the flow. Cached."""
    _, c, h, w = shape
    largest = [(c - 1) * s[1] + (h - 1) * s[2] + (w - 1) * s[3]
               for s in image_strides]
    if (max(largest, default=0) > INT32_MAX
            or (w - 1) * flow_strides[2] + flow_strides[3] > INT32_MAX):
        raise ValueError(f"{name}: an image of {c}x{h}x{w} with strides "
                         f"{image_strides} or a flow with strides "
                         f"{flow_strides} exceeds the kernel's 32-bit "
                         f"offsets")


@functools.lru_cache(maxsize=256)
def _planes_plan(shape: torch.Size, flow_shape: torch.Size,
                 flow_strides: tuple, band: int, band_valid: int) -> None:
    """Raise unless K1 can take contiguous planes of ``shape`` and a flow of
    ``flow_shape`` and ``flow_strides``: the shapes of
    ``check_warp_shapes``, a valid band geometry, a grid that fits, and
    offsets that fit the kernel's 32 bits (``check_offsets``). Cached: a
    path calls it with the same arguments every frame."""
    check_warp_shapes("warp_planes", shape, flow_shape)
    n, c, h, w = shape
    check_band(h, band, band_valid)
    tile_plan(n, h, w)
    check_offsets("warp_planes", shape, flow_strides, (c * h * w, h * w, w, 1))


@functools.lru_cache(maxsize=256)
def _rgb_plan(shape: torch.Size, strides: tuple, out_strides: tuple,
              flow_strides: tuple) -> None:
    """Raise unless K2's grid fits and its 32-bit offsets (an image and an
    output of any strides) do. Cached."""
    n, _, h, w = shape
    tile_plan(n, h, w)
    check_offsets("warp_rgb", shape, flow_strides, strides, out_strides)


def bilinear_taps(flow: torch.Tensor, h: int, w: int, band: int = 0,
                  band_valid: int = 0, out_y0: int = 0, h_glob: int = 0):
    """The fp32 stencil of every output pixel for an (n, H, W, 2) flow:
    int64 tap indices (y0, x0, y1, x1) and fractional weights (wy, wx),
    each (n, H, W), in the kernels' order of operations. ``band`` > 0
    takes each row relative to its band of ``band`` rows and clamps it to
    the band's first ``band_valid`` rows (K1's band mode). ``h_glob`` > 0
    takes output row i as row ``out_y0 + i`` of an ``h_glob``-row image and
    clamps there (K1's window mode; the rows are global)."""
    f = flow.float()
    rows = torch.arange(h, device=flow.device)[:, None]
    first, rows_valid = 0, h
    if band:
        first, rows, rows_valid = rows - rows % band, rows % band, band_valid
    elif h_glob:
        rows, rows_valid = rows + out_y0, h_glob
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
    """The values of img (n, c, H, W) at the (n, Ho, W) tap indices: (n, c,
    Ho, W)."""
    n, c, h, w = img.shape
    ho = yi.shape[1]
    idx = (yi * w + xi).reshape(n, 1, ho * w).expand(n, c, ho * w)
    return img.reshape(n, c, h * w).gather(2, idx).reshape(n, c, ho, w)


def _blend(planes, y0i, x0i, y1i, x1i, wy, wx) -> torch.Tensor:
    """The bilinear sum of ``planes``' four taps in fp32, in the kernels'
    order of operations, cast to the planes' dtype."""
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
    return _blend(planes, *bilinear_taps(flow, h, w, band, band_valid))


def check_window(shape: torch.Size, flow_shape: torch.Size,
                 h_glob: int) -> None:
    """Raise unless planes of ``shape`` (n, c, hx, W) and a flow of
    ``flow_shape`` (n, ho, W, 2) make a window warp of an ``h_glob``-row
    image."""
    if len(shape) != 4 or len(flow_shape) != 4:
        raise ValueError(f"warp_planes_window: planes must be (n, c, hx, W) "
                         f"and flow (n, ho, W, 2); got {tuple(shape)} and "
                         f"{tuple(flow_shape)}")
    n, _, hx, w = shape
    if (flow_shape[0], flow_shape[2], flow_shape[3]) != (n, w, 2):
        raise ValueError(f"warp_planes_window: flow must be (n, ho, W, 2) "
                         f"with (n, W) = {(n, w)}, got {tuple(flow_shape)}")
    if hx < 1 or h_glob < 1:
        raise ValueError(f"warp_planes_window: the slab (hx={hx}) and the "
                         f"image (h_glob={h_glob}) need rows")


def warp_planes_window_reference(planes: torch.Tensor, flow: torch.Tensor,
                                 out_y0: int, x_y0: int,
                                 h_glob: int) -> torch.Tensor:
    """Plain PyTorch version of K1's window mode (``warp_planes_window``):
    ``bilinear_taps`` in global rows, then only the clamped integer tap
    rows translated by ``-x_y0`` into the slab (and clipped to it), the
    float coordinates untouched, as
    ``tecogan_tpu/ops/warp.py::backward_warp_window`` orders it."""
    check_window(planes.shape, flow.shape, h_glob)
    hx, w = planes.shape[-2:]
    y0g, x0i, y1g, x1i, wy, wx = bilinear_taps(flow, flow.shape[1], w,
                                               out_y0=out_y0, h_glob=h_glob)
    y0i = torch.clamp(y0g - x_y0, 0, hx - 1)
    y1i = torch.clamp(y1g - x_y0, 0, hx - 1)
    return _blend(planes, y0i, x0i, y1i, x1i, wy, wx)


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

    Calls the operator ``tecogan_torch::warp_planes``. CPU tensors:
    ``warp_planes_reference``. CUDA tensors: K1, launched on the current
    stream; the planes are contiguous NCHW, the flow may have any strides
    (e.g. the (n, H, W, 2) view of an NCHW flow). Other devices raise.
    ``warp_planes.launches`` counts kernel launches, and
    ``warp_planes.band_launches`` those of them in band mode, whether the
    call comes from the live path or from a loaded program.
    """
    return _PLANES_OP(planes, flow, band, band_valid)


def _warp_planes_cuda(planes: torch.Tensor, flow: torch.Tensor,
                      band: int = 0, band_valid: int = 0) -> torch.Tensor:
    """The operator's CUDA implementation: checks, then one K1 launch."""
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


def require_fake(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a fake tensor: an operator's fake
    implementation serves tracing only, and a plain meta tensor (or a mix
    of meta and CPU tensors) has no kernel."""
    if not all(is_fake(t) for t in tensors):
        devs = ", ".join(str(t.device) for t in tensors)
        raise ValueError(f"{name} runs on CPU tensors (plain version) or "
                         f"CUDA tensors (kernel); got {devs}")


def _warp_planes_fake(planes: torch.Tensor, flow: torch.Tensor,
                      band: int = 0, band_valid: int = 0) -> torch.Tensor:
    require_fake("warp_planes", planes, flow)
    check_warp_shapes("warp_planes", planes.shape, flow.shape)
    check_band(planes.shape[-2], band, band_valid)
    return torch.empty_like(planes, memory_format=torch.contiguous_format)


OPS.define("warp_planes(Tensor planes, Tensor flow, int band=0, "
           "int band_valid=0) -> Tensor")
OPS.impl("warp_planes", _warp_planes_cuda, "CUDA")
OPS.impl("warp_planes", warp_planes_reference, "CPU")
torch.library.register_fake("tecogan_torch::warp_planes", _warp_planes_fake,
                            lib=OPS)
_PLANES_OP = torch.ops.tecogan_torch.warp_planes.default


@functools.lru_cache(maxsize=256)
def _window_plan(shape: torch.Size, flow_shape: torch.Size,
                 flow_strides: tuple, h_glob: int) -> None:
    """Raise unless K1's window mode can take contiguous planes of
    ``shape`` and a flow of ``flow_shape`` and ``flow_strides``. Cached."""
    check_window(shape, flow_shape, h_glob)
    n, c, hx, w = shape
    ho = flow_shape[1]
    tile_plan(n, ho, w)
    for rows in (hx, ho):
        check_offsets("warp_planes_window", (n, c, rows, w), flow_strides,
                      (c * rows * w, rows * w, w, 1))


def warp_planes_window(planes: torch.Tensor, flow: torch.Tensor,
                       out_y0: int, x_y0: int, h_glob: int) -> torch.Tensor:
    """K1's window mode: warp a row slab of a taller image.

    ``planes`` (n, c, hx, W) holds the global rows ``[x_y0, x_y0 + hx)``
    of an ``h_glob``-row image (x_y0 may be negative: rows outside the
    image are filler no kept output reads); ``flow`` (n, ho, W, 2) is the
    flow of the output rows ``[out_y0, out_y0 + ho)``. Output row i samples
    at ``clip(out_y0 + i + fy, 0, h_glob - 1)`` and ``clip(j + fx, 0,
    W - 1)``: coordinates, floor and weights in global rows, then the
    integer tap rows translated into the slab and clipped to it. Returns
    (n, c, ho, W) in the planes' dtype. With ``out_y0 = x_y0 = 0`` and
    ``h_glob = hx = ho`` it is ``warp_planes``, bit for bit.

    CPU tensors: ``warp_planes_window_reference``. CUDA tensors: K1's
    kernel body in its window instantiation (``csrc/warp_planes.cu``),
    launched on the current stream; the planes are contiguous NCHW, the
    flow may have any strides. Other devices raise.
    ``warp_planes_window.launches`` counts kernel launches.
    """
    if all_on_cpu(planes, flow):
        return warp_planes_window_reference(planes, flow, out_y0, x_y0,
                                            h_glob)
    index = cuda_index("warp_planes_window", planes, flow)
    name = _WINDOW_ENTRY.get((planes.dtype, flow.dtype))
    if name is None:
        raise TypeError(f"warp_planes_window takes float32/bfloat16, got "
                        f"{[planes.dtype, flow.dtype]}")
    fs = flow.stride()
    _window_plan(planes.shape, flow.shape, fs, h_glob)
    if not planes.is_contiguous():
        raise ValueError("warp_planes_window: planes must be contiguous "
                         "NCHW")
    n, c, hx, w = planes.shape
    ho = flow.shape[1]
    out = torch.empty((n, c, ho, w), dtype=planes.dtype,
                      device=planes.device)
    launch(name, index, planes.data_ptr(), flow.data_ptr(), out.data_ptr(),
           n, c, ho, w, hx, out_y0, x_y0, h_glob, *fs)
    warp_planes_window.launches += 1
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
    out = torch.empty_like(x)
    xs, os_, fs = x.stride(), out.stride(), flow.stride()
    _rgb_plan(x.shape, xs, os_, fs)
    n, c, h, w = x.shape
    launch(name, index, x.data_ptr(), flow.data_ptr(), out.data_ptr(), n, c,
           h, w, *xs, *os_, *fs)
    warp_rgb.launches += 1
    return out


def zero_taps(sy: torch.Tensor, sx: torch.Tensor, h: int, w: int):
    """The zero-padded bilinear stencil of fp32 sample points (sy, sx) of
    an h x w image, as ``csrc/warp_common.cuh::zero_taps`` computes it:
    the coordinate floored with no clamp, the four weights (1-wx)(1-wy),
    wx(1-wy), (1-wx)wy, wx*wy, each 0 where its tap lies outside the
    image, and the int64 tap indices (y0, x0, y1, x1) clamped into it.
    Returns (y0, x0, y1, x1, w00, w01, w10, w11)."""
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    wy = sy - y0f
    wx = sx - x0f
    wy0 = 1.0 - wy
    wx0 = 1.0 - wx
    ry0 = (y0f >= 0) & (y0f <= h - 1)
    ry1 = (y0f >= -1) & (y0f <= h - 2)
    rx0 = (x0f >= 0) & (x0f <= w - 1)
    rx1 = (x0f >= -1) & (x0f <= w - 2)
    w00 = torch.where(ry0 & rx0, wx0 * wy0, 0.0)
    w01 = torch.where(ry0 & rx1, wx * wy0, 0.0)
    w10 = torch.where(ry1 & rx0, wx0 * wy, 0.0)
    w11 = torch.where(ry1 & rx1, wx * wy, 0.0)
    y0 = torch.clamp(y0f, -1.0, float(h)).long()
    x0 = torch.clamp(x0f, -1.0, float(w)).long()
    return (y0.clamp(0, h - 1), x0.clamp(0, w - 1), (y0 + 1).clamp(0, h - 1),
            (x0 + 1).clamp(0, w - 1), w00, w01, w10, w11)


def warp_zero_reference(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1's zero padding (``warp_zero``): x (n, c,
    H, W), any strides, sampled at (i + fy, j + fx) along flow (n, H, W,
    2), taps outside the image reading 0; fp32 arithmetic in the kernel's
    order, the output in x's dtype and memory format."""
    n, c, h, w = x.shape
    f = flow.float()
    ii = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    jj = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    y0, x0, y1, x1, w00, w01, w10, w11 = zero_taps(ii + f[..., 1],
                                                   jj + f[..., 0], h, w)
    xf = x.float()
    top = (w00[:, None] * gather_tap(xf, y0, x0)
           + w01[:, None] * gather_tap(xf, y0, x1))
    bot = (w10[:, None] * gather_tap(xf, y1, x0)
           + w11[:, None] * gather_tap(xf, y1, x1))
    out = torch.empty_like(x)
    out.copy_(top + bot)
    return out


def warp_zero(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x, logically (n, c, H, W), along flow (n, H, W, 2) with zero
    padding: pixel (i, j) samples at (i + fy, j + fx) and taps outside the
    image read 0 (``F.grid_sample(padding_mode="zeros",
    align_corners=True)``, BasicVSR++'s ``flow_warp``).

    CPU tensors: ``warp_zero_reference``. CUDA tensors, launched on the
    current stream with an fp32 flow of any strides and no copy (the
    output is ``torch.empty_like(x)``): a channels_last image of 8 k
    channels takes the channel-vector kernel (``_nhwc_vectors``), any other
    image K1's kernel body in its zero-padding instantiation on K2's
    strides; both round as the plain version. ``warp_zero.launches``
    counts kernel launches.
    """
    if all_on_cpu(x, flow):
        return warp_zero_reference(x, flow)
    index = check_cuda_warp_args("warp_zero", x, flow)
    if flow.dtype != torch.float32:
        raise TypeError(f"warp_zero takes an fp32 flow, got {flow.dtype}")
    out = torch.empty_like(x)
    xs, os_, fs = x.stride(), out.stride(), flow.stride()
    _rgb_plan(x.shape, xs, os_, fs)
    n, c, h, w = x.shape
    kind = "zero_nhwc" if _nhwc_vectors(x, out) else "zero"
    tag = _DTYPE_TAG[x.dtype] + ("" if kind == "zero_nhwc" else "_f32")
    launch(f"tecogan_warp_{kind}_{tag}", index, x.data_ptr(),
           flow.data_ptr(), out.data_ptr(), n, c, h, w, *xs, *os_, *fs)
    warp_zero.launches += 1
    return out


def _nhwc_vectors(*tensors: torch.Tensor) -> bool:
    """Whether each (n, c, H, W) tensor is channels_last with its channels,
    strides and address in whole 16-byte vectors of 8 elements (bf16 or
    fp32), as ``tecogan_warp_zero_nhwc_*`` takes them."""
    return all(t.stride(1) == 1 and t.shape[1] % 8 == 0
               and all(t.stride(d) % 8 == 0 for d in (0, 2, 3))
               and t.data_ptr() % 16 == 0 for t in tensors)


warp_planes.launches = 0
warp_planes.band_launches = 0
warp_zero.launches = 0
warp_planes_window.launches = 0
warp_rgb.launches = 0
