"""The epilogue of a bf16 inference convolution: the bias, the activation
and a residual in one pass over the bias-free convolution output (CUDA
kernel ``csrc/conv_epilogue.cu`` and its plain PyTorch version).

It replaces no TPU kernel: on the TPU XLA fuses the epilogue into the
convolution. On the card PyTorch adds a convolution's bias in a pass of its
own, a broadcast over a channels_last output that it cannot vectorise, and
the activation and the residual add are a pass each. For the bias-free
bf16 output ``y`` (n, C, H, W), the bias (C,), an activation ``act`` (0
none, 1 ReLU, 2 LeakyReLU with ``slope``) and an optional residual of y's
shape, the epilogue computes

- ``t = bf16(float(y) + float(bias))``;
- ``a = bf16(act(float(t)))`` (LeakyReLU: ``t > 0 ? t : t * slope`` with
  the slope in fp32);
- ``out = bf16(float(a) + float(residual))``,

rounding where PyTorch's unfused bf16 chain (``y + bias.view(1, C, 1, 1)``,
then ``F.relu`` or ``F.leaky_relu``, then ``residual + ...``) rounds, so all
three agree bit for bit. ``y`` is channels_last on the live path (cuDNN's
output for a channels_last input) and may have any strides (a traced
program's fake convolution output is contiguous); the residual is
channels_last or contiguous NCHW, and the output takes the residual's
layout (y's without one): an NCHW residual gives an NCHW output, as
``residual + y`` does. The kernel's vector path takes dense channels_last
operands of 8 k channels, its scalar path any other.

The operator ``tecogan_torch::conv_epilogue`` (``warp_cuda.OPS``) runs the
kernel on CUDA tensors and the plain version on CPU tensors; its fake
implementation gives the output's shape, dtype and strides, so that
``torch.export`` traces through it. ``nn.conv_act`` is its caller.
"""

from __future__ import annotations

import functools
import struct

import torch

from .warp_cuda import INT32_MAX, OPS, cuda_index, launch, require_fake

__all__ = ["ACT_NONE", "ACT_RELU", "ACT_LEAKY_RELU", "conv_epilogue",
           "conv_epilogue_reference"]

ACT_NONE, ACT_RELU, ACT_LEAKY_RELU = 0, 1, 2
_VEC = 8  # channels of one 16-byte vector (csrc/conv_epilogue.cu kVec)
# the slope's fp32 bits
_F32, _F32_BITS = struct.Struct("<f"), struct.Struct("<I")


def _check_args(y: torch.Tensor, bias: torch.Tensor,
                residual: torch.Tensor | None, act: int) -> None:
    """Raise unless y is (n, C, H, W), the bias a contiguous (C,), the
    residual of y's shape, channels_last or contiguous NCHW, all bf16, and
    ``act`` one of the three activations."""
    shape = y.shape
    if len(shape) != 4:
        raise ValueError(f"conv_epilogue: y must be (n, C, H, W), got "
                         f"{tuple(shape)}")
    if tuple(bias.shape) != (shape[1],):
        raise ValueError(f"conv_epilogue: the bias must be ({shape[1]},), "
                         f"got {tuple(bias.shape)}")
    if residual is not None and residual.shape != shape:
        raise ValueError(f"conv_epilogue: the residual must be "
                         f"{tuple(shape)}, got {tuple(residual.shape)}")
    if act not in (ACT_NONE, ACT_RELU, ACT_LEAKY_RELU):
        raise ValueError(f"conv_epilogue: act must be 0 (none), 1 (ReLU) or "
                         f"2 (LeakyReLU), got {act}")
    if shape.numel() > INT32_MAX:
        raise ValueError(f"conv_epilogue: {tuple(shape)} exceeds the "
                         f"kernel's 32-bit thread indices")
    tensors = (y, bias) if residual is None else (y, bias, residual)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"conv_epilogue takes bf16 operands, got "
                        f"{[t.dtype for t in tensors]}")
    if not bias.is_contiguous():
        raise ValueError("conv_epilogue: the bias must be contiguous")
    if residual is not None and not (
            residual.is_contiguous()
            or residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("conv_epilogue: the residual must be channels_last "
                         "or contiguous NCHW")


def _specs(*tensors) -> tuple:
    """(shape, strides, dtype) of each tensor, None for None."""
    return tuple(None if t is None else (t.shape, t.stride(), t.dtype)
                 for t in tensors)


def _dense_nhwc(shape: torch.Size, strides: tuple) -> bool:
    """Whether a tensor of ``shape`` and ``strides`` is dense channels_last
    with whole 16-byte vectors of channels."""
    n, c, h, w = shape
    return c % _VEC == 0 and strides == (h * w * c, 1, w * c, c)


@functools.lru_cache(maxsize=512)
def _plan(y: tuple, bias: tuple, residual: tuple | None, act: int) -> bool:
    """``_check_args`` for operands of these ``_specs``, and whether the
    vector path takes them, short of their addresses' alignment. Cached: a
    network's convolutions repeat a few configurations, and the checks
    cost the host more than the launch."""
    def like(spec):
        return None if spec is None else torch.empty_strided(
            spec[0], spec[1], dtype=spec[2], device="meta")

    _check_args(like(y), like(bias), like(residual), act)
    shape, strides = y[0], y[1]
    out = strides if residual is None else residual[1]
    return _dense_nhwc(shape, strides) and _dense_nhwc(shape, out)


def _empty_out(y: torch.Tensor, residual: torch.Tensor | None):
    return torch.empty_like(y if residual is None else residual)


def conv_epilogue_reference(y: torch.Tensor, bias: torch.Tensor,
                            residual: torch.Tensor | None = None,
                            act: int = ACT_NONE,
                            slope: float = 0.0) -> torch.Tensor:
    """Plain PyTorch epilogue (module docstring): fp32 arithmetic with a
    bf16 rounding after the bias, after the activation and after the
    residual, in the kernel's order; the output in the residual's layout
    (y's without one)."""
    _plan(*_specs(y, bias, residual), act)
    t = (y.float() + bias.float().view(1, -1, 1, 1)).to(torch.bfloat16)
    if act == ACT_RELU:
        t = torch.relu(t)
    elif act == ACT_LEAKY_RELU:
        tf = t.float()
        t = torch.where(tf > 0, tf, tf * slope).to(torch.bfloat16)
    if residual is not None:
        t = (t.float() + residual.float()).to(torch.bfloat16)
    out = _empty_out(y, residual)
    out.copy_(t)
    return out


def _conv_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor,
                        residual: torch.Tensor | None = None,
                        act: int = ACT_NONE,
                        slope: float = 0.0) -> torch.Tensor:
    """The operator's CUDA implementation: checks (``_plan``), then one
    launch."""
    index = y.get_device()
    if residual is None:
        res, rs, rp = None, (0, 0, 0, 0), 0
        same = bias.get_device() == index
    else:
        rs, rp = residual.stride(), residual.data_ptr()
        res = (residual.shape, rs, residual.dtype)
        same = bias.get_device() == index == residual.get_device()
    if index < 0 or not same:  # raises, naming the devices
        cuda_index("conv_epilogue", *(t for t in (y, bias, residual)
                                      if t is not None))
    ys = y.stride()
    vec = _plan((y.shape, ys, y.dtype),
                (bias.shape, bias.stride(), bias.dtype), res, act)
    out = _empty_out(y, residual)
    yp, bp, op = y.data_ptr(), bias.data_ptr(), out.data_ptr()
    vec = vec and not (yp | bp | rp | op) % 16
    n, c, h, w = y.shape
    bits = _F32_BITS.unpack(_F32.pack(slope))[0] if slope else 0
    launch("tecogan_conv_epilogue_bf16", index, yp, bp, rp, op, n, c, h, w,
           act, bits, int(residual is not None), int(vec), *ys, *rs,
           *out.stride())
    conv_epilogue.launches += 1
    return out


def _conv_epilogue_fake(y: torch.Tensor, bias: torch.Tensor,
                        residual: torch.Tensor | None = None,
                        act: int = ACT_NONE,
                        slope: float = 0.0) -> torch.Tensor:
    tensors = (y, bias) if residual is None else (y, bias, residual)
    require_fake("conv_epilogue", *tensors)
    _plan(*_specs(y, bias, residual), act)
    return _empty_out(y, residual)


OPS.define("conv_epilogue(Tensor y, Tensor bias, Tensor? residual=None, "
           "int act=0, float slope=0.0) -> Tensor")
OPS.impl("conv_epilogue", _conv_epilogue_cuda, "CUDA")
OPS.impl("conv_epilogue", conv_epilogue_reference, "CPU")
torch.library.register_fake("tecogan_torch::conv_epilogue",
                            _conv_epilogue_fake, lib=OPS)
_OP = torch.ops.tecogan_torch.conv_epilogue.default


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None = None, act: int = ACT_NONE,
                  slope: float = 0.0) -> torch.Tensor:
    """The epilogue of the bias-free bf16 convolution output ``y``
    (module docstring), through the operator
    ``tecogan_torch::conv_epilogue``. CPU tensors:
    ``conv_epilogue_reference``. CUDA tensors: the kernel, launched on the
    current stream; a plain CUDA tensor (not a tracer's subclass) goes to
    the operator's CUDA implementation directly, without the dispatcher's
    round trip into Python, which costs the host about as much as the
    launch. A wrong dtype, layout or shape raises.
    ``conv_epilogue.launches`` counts kernel launches, whether the call
    comes from the live path or from a loaded program."""
    if type(y) is torch.Tensor and y.is_cuda:
        return _conv_epilogue_cuda(y, bias, residual, act, slope)
    return _OP(y, bias, residual, act, slope)


conv_epilogue.launches = 0
