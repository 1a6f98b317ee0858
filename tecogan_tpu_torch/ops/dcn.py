"""The modulated deformable convolution (DCNv2) of BasicVSR++'s
second-order deformable alignment: the column gather (CUDA kernel
``csrc/dcn.cu`` and its plain PyTorch version) and the product with the
weight.

It replaces no TPU kernel (the JAX package has no BasicVSR++). mmcv's
``modulated_deform_conv2d`` at 3x3, padding 1, stride 1, dilation 1 and
``groups`` deformable groups samples each input channel of group g at tap
k = 3 ky + kx of output pixel (i, j) at ``(i - 1 + ky + dy, j - 1 + kx +
dx)``, bilinearly with zero padding (``warp_cuda.zero_taps``), multiplies
by the tap's mask and sums against the weight. BasicVSR++ derives the
offsets and the mask from conv_offset's raw ``27 * groups`` channels and
two flows; that epilogue is part of the gather here, in fp32:

- ``dy = mag * tanh(raw[2 (9 g + k)]) + flow_g[1]``,
  ``dx = mag * tanh(raw[2 (9 g + k) + 1]) + flow_g[0]``, where flow_g is
  ``flow1`` for the first half of the groups and ``flow2`` for the rest
  (mmagic's ``flip(1)`` and ``repeat`` of each flow over its half of the
  offsets, in mmcv's (dy, dx) channel order);
- ``mask = sigmoid(raw[18 groups + 9 g + k])``.

The columns are (pixels, 9 C) in the order (tap, channel): the
channels_last weight's own order, so ``weight.permute(0, 2, 3, 1)`` is a
view, and the product's (pixels, O) output is a channels_last feature map
with no copy. The wrapper dispatches on where its tensors lie: CPU tensors
take ``dcn_columns_reference``, CUDA tensors the kernel; nothing falls
back.
"""

from __future__ import annotations

import functools
import struct

import torch

from .warp_cuda import (INT32_MAX, all_on_cpu, cuda_index, gather_tap,
                        launch, zero_taps)

__all__ = ["GROUP_CHANNELS", "dcn_columns", "dcn_columns_reference",
           "modulated_deform_conv"]

GROUP_CHANNELS = 8  # channels of one deformable group (csrc/dcn.cu kGroupC)
_TAG = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=64)
def _check(shape: torch.Size, raw_shape: torch.Size, flow_shapes: tuple,
           groups: int) -> None:
    """Raise unless x is (n, C, H, W) with ``groups`` groups of
    ``GROUP_CHANNELS`` channels (an even count of groups), raw (n, 27
    groups, H, W) and each flow (n, 2, H, W). Cached."""
    if len(shape) != 4:
        raise ValueError(f"dcn: x must be (n, C, H, W), got {tuple(shape)}")
    n, c, h, w = shape
    if groups < 2 or groups % 2 or c != groups * GROUP_CHANNELS:
        raise ValueError(f"dcn: {c} channels in {groups} groups; the kernel "
                         f"takes an even number of groups of "
                         f"{GROUP_CHANNELS} channels")
    if raw_shape != (n, 27 * groups, h, w):
        raise ValueError(f"dcn: raw must be {(n, 27 * groups, h, w)}, got "
                         f"{tuple(raw_shape)}")
    for fs in flow_shapes:
        if fs != (n, 2, h, w):
            raise ValueError(f"dcn: each flow must be {(n, 2, h, w)}, got "
                             f"{tuple(fs)}")
    if n * h * w * 9 * groups > INT32_MAX:
        raise ValueError(f"dcn: {n}x{h}x{w} pixels exceed the kernel's "
                         f"32-bit thread indices")


def dcn_columns_reference(x: torch.Tensor, raw: torch.Tensor,
                          flow1: torch.Tensor, flow2: torch.Tensor,
                          max_mag: float, groups: int) -> torch.Tensor:
    """Plain PyTorch column gather: (n H W, 9 C) in x's dtype, column
    ``9 C`` index ``k C + c`` holding channel c sampled at tap k of the
    pixel and multiplied by its mask. fp32 arithmetic in the kernel's
    order of operations."""
    n, c, h, w = x.shape
    g, cg = groups, c // groups
    r = raw.float()
    oy = r[:, 0:18 * g:2].reshape(n, g, 9, h, w)
    ox = r[:, 1:18 * g:2].reshape(n, g, 9, h, w)
    mask = torch.sigmoid(r[:, 18 * g:27 * g].reshape(n, g, 9, h, w))
    half = g // 2
    flows = torch.cat([flow1.float()[:, None].expand(n, half, 2, h, w),
                       flow2.float()[:, None].expand(n, g - half, 2, h, w)],
                      1)[:, :, None]  # (n, g, 1, 2, h, w)
    dy = max_mag * torch.tanh(oy) + flows[:, :, :, 1]
    dx = max_mag * torch.tanh(ox) + flows[:, :, :, 0]
    k = torch.arange(9, device=x.device)
    ky, kx = k // 3, k % 3
    base_y = (torch.arange(h, device=x.device)[:, None]
              + ky[:, None, None] - 1).float()  # (9, h, 1)
    base_x = (torch.arange(w, device=x.device)[None, :]
              + kx[:, None, None] - 1).float()  # (9, 1, w)
    y0, x0, y1, x1, w00, w01, w10, w11 = zero_taps(base_y + dy, base_x + dx,
                                                   h, w)
    # the groups as images of cg channels, each tap's samples as 9 h rows
    xf = x.float().reshape(n * g, cg, h, w)

    def tap(yi, xi):
        return gather_tap(xf, yi.reshape(n * g, 9 * h, w),
                          xi.reshape(n * g, 9 * h, w)).reshape(
            n, g, cg, 9, h, w)

    def wt(a):
        return a[:, :, None]

    top = wt(w00) * tap(y0, x0) + wt(w01) * tap(y0, x1)
    bot = wt(w10) * tap(y1, x0) + wt(w11) * tap(y1, x1)
    val = (top + bot) * wt(mask)  # (n, g, cg, 9, h, w)
    return val.permute(0, 4, 5, 3, 1, 2).reshape(n * h * w, 9 * c).to(
        x.dtype)


def dcn_columns(x: torch.Tensor, raw: torch.Tensor, flow1: torch.Tensor,
                flow2: torch.Tensor, max_mag: float,
                groups: int) -> torch.Tensor:
    """The columns of ``modulated_deform_conv``: (n H W, 9 C) in x's dtype.

    CPU tensors: ``dcn_columns_reference``. CUDA tensors: the kernel
    (``csrc/dcn.cu``), launched on the current stream; x and raw in fp32
    or bf16 (the same dtype), the flows fp32, each of any strides (one
    16-byte load per corner where x's channels are contiguous,
    channels_last). ``dcn_columns.launches`` counts kernel launches.
    """
    _check(x.shape, raw.shape, (flow1.shape, flow2.shape), groups)
    if all_on_cpu(x, raw, flow1, flow2):
        return dcn_columns_reference(x, raw, flow1, flow2, max_mag, groups)
    index = cuda_index("dcn_columns", x, raw, flow1, flow2)
    if (x.dtype not in _TAG or raw.dtype != x.dtype
            or flow1.dtype != torch.float32 or flow2.dtype != torch.float32):
        raise TypeError(f"dcn_columns takes x and raw in one of fp32/bf16 "
                        f"and fp32 flows, got {x.dtype}, {raw.dtype}, "
                        f"{flow1.dtype}, {flow2.dtype}")
    n, c, h, w = x.shape
    col = torch.empty((n * h * w, 9 * c), dtype=x.dtype, device=x.device)
    xs = x.stride()
    vec = (xs[1] == 1 and all(s % GROUP_CHANNELS == 0
                              for s in (xs[0], xs[2], xs[3]))
           and x.data_ptr() % 16 == 0)
    bits = struct.unpack("<I", struct.pack("<f", float(max_mag)))[0]
    launch(f"tecogan_dcn_columns_{_TAG[x.dtype]}", index, x.data_ptr(),
           raw.data_ptr(), flow1.data_ptr(), flow2.data_ptr(),
           col.data_ptr(), n, c, h, w, groups, bits, int(vec), *xs,
           *raw.stride(), *flow1.stride(), *flow2.stride())
    dcn_columns.launches += 1
    return col


dcn_columns.launches = 0


def modulated_deform_conv(x: torch.Tensor, raw: torch.Tensor,
                          flow1: torch.Tensor, flow2: torch.Tensor,
                          weight: torch.Tensor, bias: torch.Tensor | None,
                          max_mag: float, groups: int) -> torch.Tensor:
    """BasicVSR++'s flow-guided DCNv2 (module docstring): x (n, C, H, W),
    conv_offset's raw output (n, 27 groups, H, W), the two fp32 flows (n,
    2, H, W), the weight (O, C, 3, 3) and bias (O,) -> (n, O, H, W), a
    channels_last view of the product's output. The columns
    (``dcn_columns``) times the weight is one matrix product (cuBLAS on a
    card), in x's dtype."""
    n, _, h, w = x.shape
    o = weight.shape[0]
    col = dcn_columns(x, raw, flow1, flow2, max_mag, groups)
    wt = weight.permute(0, 2, 3, 1).reshape(o, -1).t()
    out = (col @ wt) if bias is None else torch.addmm(bias, col, wt)
    return out.view(n, h, w, o).permute(0, 3, 1, 2)
