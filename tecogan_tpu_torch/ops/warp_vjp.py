"""Differentiable backward warp for training: K2 forward, K3/K4 backward.

Port of ``tecogan_tpu/ops/warp_vjp.py``. ``backward_warp_diff`` is a
``torch.autograd.Function`` whose forward is K2 (``warp_cuda.warp_rgb``)
and whose backward is two kernels, the counterpart of the custom VJP
``_warp_cvjp``:

- K3, ``warp_dimage``: the adjoint with respect to the image, replacing
  ``_dimage`` (kernel ``_dimage_kernel``). Each output pixel's cotangent
  times its four bilinear weights, ``(g * w_y) * w_x`` in fp32, is added
  into its four clamped source taps. The sums are exact integers at one
  power-of-two scale a call, ``2^k`` with ``k = 62 - e(M) -
  ceil(log2(H * W))`` (``M = max |g|``, ``e`` its frexp exponent, so no
  int64 sum can overflow); each product is rounded to an integer once, and
  each sum converted back once. So the result is deterministic, the same
  on the card and on the CPU, and within an fp32 rounding of the exact
  adjoint. A non-finite ``g`` takes fp32 sums for that call. On the card
  this is one cooperative kernel launch (``csrc/warp_vjp.cu``) that zeroes
  its scratch, reduces ``M``, scatters with 64-bit integer atomics and
  writes the output in the image's dtype; the wrapper only allocates.
- K4, ``warp_dflow``: the adjoint with respect to the flow, replacing
  ``_dflow`` (kernel ``_dflow_kernel``), from the four tap values, masked
  where the unclamped coordinate is below 0 and summed over channels; fp32,
  returned in the flow's dtype. Deterministic.

Images are logically (n, c, H, W) with any strides (NCHW or channels_last)
and flows (n, H, W, 2). There is no size gate and no gather fallback: CPU
tensors take the plain versions below, CUDA tensors the kernels, and
anything else raises.
"""

from __future__ import annotations

import functools

import torch

from .warp_cuda import (_DTYPE_TAG, all_on_cpu, bilinear_taps,
                        check_cuda_warp_args, check_offsets, gather_tap,
                        launch, warp_rgb)

__all__ = ["backward_warp_diff", "dimage_scale", "warp_dimage",
           "warp_dimage_reference", "warp_dflow", "warp_dflow_reference"]

# the most blocks of K3 (4 warps each) an SM holds: 2048 threads
_DIMAGE_BLOCKS_PER_SM = 16


def dimage_terms(g: torch.Tensor, flow: torch.Tensor):
    """K3's scatter as (index, products): for every output pixel and each of
    its four taps, the tap's flat index in its (H*W) plane, (n, 4*H*W)
    int64, and ``(g * w_y) * w_x``, (n, c, 4*H*W), in fp32 (float64 for a
    float64 g)."""
    n, c, h, w = g.shape
    y0, x0, y1, x1, wy, wx = bilinear_taps(flow, h, w)
    gf = g.to(torch.promote_types(g.dtype, torch.float32))
    idx, prods = [], []
    for yi, xi, w_y, w_x in ((y0, x0, 1.0 - wy, 1.0 - wx),
                             (y0, x1, 1.0 - wy, wx),
                             (y1, x0, wy, 1.0 - wx),
                             (y1, x1, wy, wx)):
        idx.append((yi * w + xi).reshape(n, h * w))
        prods.append(((gf * w_y[:, None]) * w_x[:, None]).reshape(n, c, -1))
    return torch.cat(idx, 1), torch.cat(prods, 2)


def dimage_scale(m: torch.Tensor, h: int, w: int) -> int:
    """K3's exponent k for a finite fp32 ``M = max |g|`` (a 0-d tensor):
    ``62 - e(M) - ceil(log2(H * W))``, where ``e(M)`` is frexp's exponent
    (M < 2^e(M); 0 for M = 0)."""
    return 62 - int(torch.frexp(m).exponent) - (h * w - 1).bit_length()


def scatter_sums(idx: torch.Tensor, prods: torch.Tensor, h: int, w: int,
                 k: int | None) -> torch.Tensor:
    """Add ``prods`` (n, c, m) into (n, c, h, w) at the flat tap indices
    ``idx`` (n, m). ``k`` given: as int64 at scale ``2^k`` (each product
    scaled exactly in float64, rounded half to even), converted back as
    ``(double) sum * 2^-k`` rounded to fp32; in any order of the terms the
    same bits. ``k`` None: in the products' dtype, in scatter order."""
    n, c, m = prods.shape
    where = idx[:, None].expand(n, c, m)
    if k is None:
        out = torch.zeros((n, c, h * w), dtype=prods.dtype,
                          device=prods.device)
        return out.scatter_add_(2, where, prods).reshape(n, c, h, w)
    q = torch.round(prods.double() * 2.0 ** k).long()
    sums = torch.zeros((n, c, h * w), dtype=torch.int64, device=prods.device)
    sums.scatter_add_(2, where, q)
    return (sums.double() * 2.0 ** -k).float().reshape(n, c, h, w)


def warp_dimage_reference(g: torch.Tensor, flow: torch.Tensor,
                          x_dtype: torch.dtype) -> torch.Tensor:
    """Plain K3, the kernel's arithmetic step for step: ``dimage_terms``'
    fp32 products summed as integers at the scale ``dimage_scale`` gives
    for ``M = max |g|`` (``scatter_sums``), then cast to ``x_dtype``; a
    non-finite M sums in fp32. A float64 g gives the exact adjoint in
    float64 (what the kernel and this are held against). The result is laid
    out as the kernel's, ``torch.empty_like(g)``."""
    n, c, h, w = g.shape
    idx, prods = dimage_terms(g, flow)
    k = None
    if g.dtype != torch.float64:
        m = g.float().abs().max() if g.numel() else torch.zeros(())
        k = dimage_scale(m, h, w) if bool(torch.isfinite(m)) else None
    out = torch.empty_like(g, dtype=x_dtype)
    return out.copy_(scatter_sums(idx, prods, h, w, k))


def warp_dflow_reference(g: torch.Tensor, x: torch.Tensor,
                         flow: torch.Tensor) -> torch.Tensor:
    """Plain K4: ``warp_vjp.py``'s tap-difference formula, summed over
    channels in fp32; (n, H, W, 2) in the order dfx, dfy, in the flow's
    dtype."""
    h, w = x.shape[-2:]
    y0, x0, y1, x1, wy, wx = bilinear_taps(flow, h, w)
    f = flow.float()
    ii = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    jj = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    m_x = (jj + f[..., 0] >= 0.0).float()[:, None]
    m_y = (ii + f[..., 1] >= 0.0).float()[:, None]
    xf = x.float()
    a00, a01 = gather_tap(xf, y0, x0), gather_tap(xf, y0, x1)
    a10, a11 = gather_tap(xf, y1, x0), gather_tap(xf, y1, x1)
    wy, wx = wy[:, None], wx[:, None]
    tx = (1.0 - wy) * (a01 - a00) + wy * (a11 - a10)
    ty = (1.0 - wx) * (a10 - a00) + wx * (a11 - a01)
    gf = g.float()
    dfx = ((gf * m_x) * tx).sum(1)
    dfy = ((gf * m_y) * ty).sum(1)
    return torch.stack([dfx, dfy], dim=-1).to(flow.dtype)


@functools.cache
def _dimage_slots(index: int) -> int:
    """Slots for the per-block maxima of a K3 launch on CUDA device
    ``index``: at least the blocks that fit on it at once."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * _DIMAGE_BLOCKS_PER_SM


def warp_dimage(g: torch.Tensor, flow: torch.Tensor,
                x_dtype: torch.dtype) -> torch.Tensor:
    """K3: the warp's adjoint with respect to the image, for a cotangent g
    (n, c, H, W), any strides, and flow (n, H, W, 2); returned in
    ``x_dtype``, in g's memory format. CPU tensors take
    ``warp_dimage_reference``; CUDA tensors one kernel launch, bit for bit
    the same function. ``warp_dimage.launches`` counts kernel launches."""
    if all_on_cpu(g, flow):
        return warp_dimage_reference(g, flow, x_dtype)
    index = check_cuda_warp_args("warp_dimage", g, flow)
    if x_dtype not in _DTYPE_TAG:
        raise TypeError(f"warp_dimage: x_dtype must be float32/bfloat16, "
                        f"got {x_dtype}")
    name = (f"tecogan_warp_dimage_{_DTYPE_TAG[g.dtype]}_"
            f"{_DTYPE_TAG[flow.dtype]}_{_DTYPE_TAG[x_dtype]}")
    out = torch.empty_like(g, dtype=x_dtype)
    gs, os_, fs = g.stride(), out.stride(), flow.stride()
    check_offsets("warp_dimage", g.shape, fs, gs, os_)
    slots = _dimage_slots(index)
    scratch = torch.empty(out.numel() + slots, dtype=torch.int64,
                          device=g.device)
    n, c, h, w = g.shape
    launch(name, index, g.data_ptr(), flow.data_ptr(), out.data_ptr(),
           scratch.data_ptr(), n, c, h, w, slots, *gs, *os_, *fs)
    warp_dimage.launches += 1
    return out


def warp_dflow(g: torch.Tensor, x: torch.Tensor,
               flow: torch.Tensor) -> torch.Tensor:
    """K4: the warp's adjoint with respect to the flow, for a cotangent g
    and image x (n, c, H, W) of one dtype, any strides, and flow
    (n, H, W, 2); returned (n, H, W, 2) in the flow's dtype. CPU tensors
    take ``warp_dflow_reference``. ``warp_dflow.launches`` counts kernel
    launches."""
    if all_on_cpu(g, x, flow):
        return warp_dflow_reference(g, x, flow)
    index = check_cuda_warp_args("warp_dflow", x, flow, g)
    if g.dtype != x.dtype:
        raise TypeError(f"warp_dflow: g ({g.dtype}) and x ({x.dtype}) "
                        f"must share a dtype")
    name = (f"tecogan_warp_dflow_{_DTYPE_TAG[x.dtype]}_"
            f"{_DTYPE_TAG[flow.dtype]}")
    n, c, h, w = x.shape
    out = torch.empty((n, h, w, 2), dtype=torch.float32, device=x.device)
    launch(name, index, g.data_ptr(), x.data_ptr(), flow.data_ptr(),
           out.data_ptr(), n, c, h, w, *g.stride(), *x.stride(),
           *flow.stride())
    warp_dflow.launches += 1
    return out.to(flow.dtype)


warp_dimage.launches = 0
warp_dflow.launches = 0


class _WarpDiff(torch.autograd.Function):
    """Forward K2; backward K3 for the image (only when it needs a
    gradient) and K4 for the flow (likewise)."""

    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(x, flow)
        return warp_rgb(x, flow)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, flow = ctx.saved_tensors
        dx = dflow = None
        if ctx.needs_input_grad[0]:
            dx = warp_dimage(g, flow, x.dtype)
        if ctx.needs_input_grad[1]:
            dflow = warp_dflow(g, x, flow)
        return dx, dflow


def backward_warp_diff(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Differentiable warp of x (n, c, H, W) along flow (n, H, W, 2): the
    value is x's dtype; the image gradient comes back in x's dtype and the
    flow gradient in the flow's dtype."""
    return _WarpDiff.apply(x, flow)
