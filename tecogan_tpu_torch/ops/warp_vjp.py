"""Differentiable backward warp for training: K2 forward, K3/K4 backward.

Port of ``tecogan_tpu/ops/warp_vjp.py``. ``backward_warp_diff`` is a
``torch.autograd.Function`` whose forward is K2 (``warp_cuda.warp_rgb``)
and whose backward is two kernels, the counterpart of the custom VJP
``_warp_cvjp``:

- K3, ``warp_dimage``: the adjoint with respect to the image, replacing
  ``_dimage`` (kernel ``_dimage_kernel``). Each output pixel's cotangent
  times its four bilinear weights is added into its four clamped source
  taps, in fp32 (``csrc/warp_vjp.cu`` with atomics, so the sum's rounding
  varies from run to run); the result comes back in the image's dtype.
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

import ctypes

import torch

from .warp_cuda import (_DTYPE_TAG, all_on_cpu, bilinear_taps,
                        check_cuda_warp_args, gather_tap, launch, strides_arg,
                        warp_rgb)

__all__ = ["backward_warp_diff", "warp_dimage", "warp_dimage_reference",
           "warp_dflow", "warp_dflow_reference"]

# (g, flow, out, n, c, H, W, strides[12], stream)
_DIMAGE_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
                    + (ctypes.c_void_p,) * 2)
# (g, x, flow, out, n, c, H, W, strides[12], stream)
_DFLOW_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4
                   + (ctypes.c_void_p,) * 2)


def warp_dimage_reference(g: torch.Tensor, flow: torch.Tensor,
                          x_dtype: torch.dtype) -> torch.Tensor:
    """Plain K3: scatter-add of ``(g * w_y) * w_x`` into the four taps.
    Weights are fp32; products and sums are in fp32, or in float64 when g
    is float64 (the exact reference the kernel is held against)."""
    n, c, h, w = g.shape
    y0, x0, y1, x1, wy, wx = bilinear_taps(flow, h, w)
    acc = torch.promote_types(g.dtype, torch.float32)
    gf = g.to(acc)
    out = torch.zeros((n, c, h * w), dtype=acc, device=g.device)
    for yi, xi, w_y, w_x in ((y0, x0, 1.0 - wy, 1.0 - wx),
                             (y0, x1, 1.0 - wy, wx),
                             (y1, x0, wy, 1.0 - wx),
                             (y1, x1, wy, wx)):
        idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        src = (gf * w_y[:, None]) * w_x[:, None]
        out.scatter_add_(2, idx, src.reshape(n, c, h * w))
    return out.reshape(n, c, h, w).to(x_dtype)


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


def warp_dimage(g: torch.Tensor, flow: torch.Tensor,
                x_dtype: torch.dtype) -> torch.Tensor:
    """K3: the warp's adjoint with respect to the image, for a cotangent g
    (n, c, H, W), any strides, and flow (n, H, W, 2); returned in
    ``x_dtype``. CPU tensors take ``warp_dimage_reference``.
    ``warp_dimage.launches`` counts kernel launches."""
    if all_on_cpu(g, flow):
        return warp_dimage_reference(g, flow, x_dtype)
    check_cuda_warp_args("warp_dimage", g, flow)
    if x_dtype not in _DTYPE_TAG:
        raise TypeError(f"warp_dimage: x_dtype must be float32/bfloat16, "
                        f"got {x_dtype}")
    name = (f"tecogan_warp_dimage_{_DTYPE_TAG[g.dtype]}_"
            f"{_DTYPE_TAG[flow.dtype]}")
    n, c, h, w = g.shape
    out = torch.zeros_like(g, dtype=torch.float32)
    launch(name, _DIMAGE_ARGTYPES, g.device, g.data_ptr(), flow.data_ptr(),
           out.data_ptr(), n, c, h, w, strides_arg(g, out, flow))
    warp_dimage.launches += 1
    return out.to(x_dtype)


def warp_dflow(g: torch.Tensor, x: torch.Tensor,
               flow: torch.Tensor) -> torch.Tensor:
    """K4: the warp's adjoint with respect to the flow, for a cotangent g
    and image x (n, c, H, W) of one dtype, any strides, and flow
    (n, H, W, 2); returned (n, H, W, 2) in the flow's dtype. CPU tensors
    take ``warp_dflow_reference``. ``warp_dflow.launches`` counts kernel
    launches."""
    if all_on_cpu(g, x, flow):
        return warp_dflow_reference(g, x, flow)
    check_cuda_warp_args("warp_dflow", x, flow, g)
    if g.dtype != x.dtype:
        raise TypeError(f"warp_dflow: g ({g.dtype}) and x ({x.dtype}) "
                        f"must share a dtype")
    name = (f"tecogan_warp_dflow_{_DTYPE_TAG[x.dtype]}_"
            f"{_DTYPE_TAG[flow.dtype]}")
    n, c, h, w = x.shape
    out = torch.empty((n, h, w, 2), dtype=torch.float32, device=x.device)
    launch(name, _DFLOW_ARGTYPES, x.device, g.data_ptr(), x.data_ptr(),
           flow.data_ptr(), out.data_ptr(), n, c, h, w,
           strides_arg(g, x, flow))
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
