"""Layer helpers (the port of ``tecogan_tpu/nn.py``'s ``cast_params`` and
``batch_norm``), the generator's memory layout, the devices a run takes and
the numerics inference and training run under. Its ``leaky_relu`` and
``max_pool_2x2`` are torch's ``nn.LeakyReLU(0.2)`` and ``nn.MaxPool2d(2,
2)`` (floor semantics), which the networks hold as modules in the
reference's layout."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from .ops.conv_epilogue import (ACT_LEAKY_RELU, ACT_NONE, ACT_RELU,
                                conv_epilogue)
from .parallel import dist
from .utils import tracing

__all__ = ["cast_params", "conv_format", "network_layout", "cat_channels",
           "fused_epilogue", "conv_act", "run_fused", "LayoutFollowsDtype",
           "batch_norm", "no_tf32",
           "inference_numerics", "training_numerics", "F64ForwardConv2d",
           "conv2d_f64_forward", "init_torch_default", "select_device",
           "select_devices"]


def cast_params(params: dict, dtype: torch.dtype,
                memory_format: torch.memory_format = torch.preserve_format
                ) -> dict:
    """Cast the floating tensors of a name -> tensor dict to ``dtype``;
    the 4-D ones (convolution weights) take ``memory_format`` in the same
    copy (the generator's: ``conv_format(dtype)``).

    The casts are differentiable copies: a forward run on them (through
    ``torch.func.functional_call``) sends its gradients back, in fp32, to
    the fp32 master parameters they were cast from. Other tensors pass
    through unchanged.
    """
    return {k: v.to(dtype, memory_format=memory_format if v.dim() == 4
                    else torch.preserve_format)
            if v.is_floating_point() else v for k, v in params.items()}


def conv_format(dtype: torch.dtype) -> torch.memory_format:
    """The memory format of FNet's and SRNet's interior activations and
    convolution weights in ``dtype``: channels_last in bf16, whose cuDNN
    convolutions on the H100 are NHWC (an NCHW operand costs a transpose
    into the convolution and another out of it); contiguous NCHW in any
    other dtype (fp32's route, whose every convolution pass training holds
    to float64)."""
    if dtype == torch.bfloat16:
        return torch.channels_last
    return torch.contiguous_format


def network_layout(x: torch.Tensor) -> torch.memory_format:
    """``conv_format`` of the input ``x`` of one FNet or SRNet forward,
    counted in ``tracing``'s ``networks.nhwc_forwards`` (channels_last) or
    ``networks.nchw_forwards``."""
    fmt = conv_format(x.dtype)
    tracing.add("networks.nhwc_forwards" if fmt == torch.channels_last
                else "networks.nchw_forwards", 1)
    return fmt


def cat_channels(tensors, memory_format: torch.memory_format
                 ) -> torch.Tensor:
    """``torch.cat(tensors, 1)`` of (n, c_i, h, w) tensors, channels_last
    for ``memory_format`` channels_last: the NHWC views are joined along
    their last dimension by the cat's one copy."""
    if memory_format == torch.channels_last:
        return torch.cat([t.permute(0, 2, 3, 1) for t in tensors],
                         3).permute(0, 3, 1, 2)
    return torch.cat(tensors, 1)


def fused_epilogue(weight: torch.Tensor) -> bool:
    """Whether a convolution with ``weight`` takes the fused epilogue
    (``conv_act``): the weight is a bf16 channels_last CUDA tensor (as
    ``LayoutFollowsDtype`` and ``cast_params(..., conv_format(dtype))``
    keep a bf16 network's) and autograd is off (inference mode or
    ``no_grad``). The weight decides, not the input, so a program traced
    through fake tensors (``serving.export_stream``) takes the route the
    live path takes. fp32, the CPU and every forward that records a graph
    (training) keep PyTorch's own ops."""
    return (weight.is_cuda and weight.dtype == torch.bfloat16
            and not torch.is_grad_enabled()
            and weight.is_contiguous(memory_format=torch.channels_last))


def conv_act(conv: nn.Module, x: torch.Tensor, act: nn.Module | None = None,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``residual + act(conv(x))``, each part where given, for an
    ``nn.Conv2d`` or ``nn.ConvTranspose2d`` and an ``nn.ReLU`` or
    ``nn.LeakyReLU``; any other activation raises TypeError.

    Where ``fused_epilogue(conv.weight)`` holds and the convolution has a
    bias, the convolution runs without it and one kernel adds the bias,
    applies the activation and adds the residual (``ops.conv_epilogue``),
    with the roundings of the unfused bf16 chain, so the result is the same
    to the bit. Otherwise the modules are called as they are, the residual
    added last as the left operand: exactly PyTorch's unfused ops.
    """
    if act is not None and not isinstance(act, (nn.ReLU, nn.LeakyReLU)):
        raise TypeError(f"conv_act takes nn.ReLU or nn.LeakyReLU, got "
                        f"{type(act).__name__}")
    bias = conv.bias
    if bias is None or not fused_epilogue(conv.weight):
        y = conv(x) if act is None else act(conv(x))
        return y if residual is None else residual + y
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, conv.weight, None, conv.stride,
                               conv.padding, conv.output_padding,
                               conv.groups, conv.dilation)
    else:
        y = conv._conv_forward(x, conv.weight, None)
    if isinstance(act, nn.LeakyReLU):
        return conv_epilogue(y, bias, residual, ACT_LEAKY_RELU,
                             act.negative_slope)
    return conv_epilogue(y, bias, residual,
                         ACT_NONE if act is None else ACT_RELU)


def run_fused(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``seq(x)``, each convolution followed by a ReLU or LeakyReLU run as
    one ``conv_act`` (every other convolution alone through it too); the
    other modules are called as they are."""
    mods = list(seq)
    i = 0
    while i < len(mods):
        m = mods[i]
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            act = mods[i + 1] if i + 1 < len(mods) and isinstance(
                mods[i + 1], (nn.ReLU, nn.LeakyReLU)) else None
            x = conv_act(m, x, act)
            i += 1 if act is None else 2
        else:
            x = m(x)
            i += 1
    return x


def _to_conv_format(t: torch.Tensor) -> torch.Tensor:
    if t.dim() != 4 or not t.is_floating_point():
        return t
    return t.contiguous(memory_format=conv_format(t.dtype))


class LayoutFollowsDtype(nn.Module):
    """A module whose 4-D parameters (convolution weights) take
    ``conv_format`` of their dtype after every cast or move: ``.to``,
    ``.bfloat16()``, ``.float()``, ``.cuda()`` and ``to_empty`` all end in
    ``_apply``. So a bf16 copy of FNet or SRNet hands cuDNN channels_last
    weights, with no copy per call, and an fp32 one NCHW weights."""

    def _apply(self, fn, recurse=True):
        super()._apply(fn, recurse)
        return super()._apply(_to_conv_format, recurse)


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, train: bool, momentum: float = 0.1,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (N, H, W) of an (N, C, H, W) tensor, computed in fp32
    for fp32 and bf16 x (float64 stays float64) and cast back to x's dtype.
    In training mode the batch's
    statistics normalise and the fp32 running stats are updated in place
    as torch keeps them: momentum 0.1 toward the batch mean and the
    unbiased batch variance.

    In a data-parallel run (``parallel.dist``, more than one rank) the
    training statistics are the global batch's, as the JAX package's are
    under its dp mesh (``tecogan_tpu/nn.py:342-372``): the global mean,
    then the global mean of ``(x - mean)^2``, each one all-reduce of the
    local sums, and the running variance unbiased with the global count.
    The all-reduces are autograd's (``torch.distributed.nn``), so the
    backward is the global batch's too."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if not train or dist.world() == 1:
        y = F.batch_norm(xf, running_mean, running_var, weight, bias, train,
                         momentum, eps)
        return y.to(x.dtype)
    from torch.distributed.nn.functional import all_reduce

    n = x.shape[0] * x.shape[2] * x.shape[3] * dist.world()
    mean = all_reduce(xf.sum((0, 2, 3))) / n
    centred = xf - mean[:, None, None]
    var = all_reduce(centred.square().sum((0, 2, 3))) / n
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(momentum * mean.detach())
        running_var.mul_(1 - momentum).add_(
            momentum * var.detach() * (n / max(n - 1, 1)))
    y = centred * torch.rsqrt(var + eps)[:, None, None]
    if weight is not None:
        y = y * weight[:, None, None] + bias[:, None, None]
    return y.to(x.dtype)


def init_torch_default(module: nn.Module, generator: torch.Generator):
    """torch's default init, drawn from ``generator``: convolution and
    linear weights and biases U(+-1/sqrt(fan_in)), fan_in being
    ``weight[0].numel()`` (weight.size(1) times the taps) for Conv2d,
    ConvTranspose2d and Linear alike (torch's own rule), in
    ``module.modules()`` order, each weight before its bias; BatchNorm at
    scale 1, bias 0 and fresh running stats."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            with torch.no_grad():
                w.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and CUDA matmuls, restored after.

    PyTorch runs fp32 cuDNN convolutions in TF32 unless told not to
    (``torch.backends.cudnn.allow_tf32`` is on by default): a 10-bit
    mantissa for the products, where the JAX package on the CPU computes
    them in fp32.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def inference_numerics(compute_dtype: str):
    """The cuDNN and matmul settings inference runs under, restored after.

    fp32 means fp32 and the same every run: TF32 is off (``no_tf32``), and
    cuDNN's default fp32 transposed convolutions are not deterministic, so
    for float32 work cuDNN picks only deterministic algorithms. bf16 runs
    under the settings as they are (it is deterministic without them).
    """
    if compute_dtype != "float32":
        yield
        return
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with no_tf32():
            yield
    finally:
        cudnn.deterministic = saved


# whether ``F64ForwardConv2d`` computes its fp32 forward from float64
# operands: inside an fp32 training step (``training_numerics(False)``)
_F64_FORWARD = {"on": False}


@contextlib.contextmanager
def training_numerics(mixed_precision: bool):
    """The cuDNN and matmul settings a training step runs under, restored
    after.

    fp32 training (``mixed_precision: false``) means fp32: TF32 is off for
    the step's convolutions and matmuls, forward and backward, and the
    discriminator's convolutions (``F64ForwardConv2d``) compute their
    forward from float64 operands, rounded once to fp32, on every device.
    cuDNN keeps its free choice of algorithms: training promises no
    determinism, as the JAX package promises none. A mixed (bf16) step runs
    under the settings as they are.
    """
    if mixed_precision:
        yield
        return
    saved = _F64_FORWARD["on"]
    _F64_FORWARD["on"] = True
    try:
        with no_tf32():
            yield
    finally:
        _F64_FORWARD["on"] = saved


class _F64Forward(torch.autograd.Function):
    """A convolution whose forward runs in float64 and is rounded once to
    its input's dtype; its input and weight gradients are autograd's own
    for the convolution (``aten.convolution_backward`` on the fp32
    operands), so only the forward changes."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conf = (stride, padding, dilation, groups, bias is not None)
        out = F.conv2d(x.double(), weight.double(),
                       None if bias is None else bias.double(), stride,
                       padding, dilation, groups)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        need = ctx.needs_input_grad
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g, x, weight, [weight.shape[0]] if has_bias else None, stride,
            padding, dilation, False, [0, 0], groups,
            [need[0], need[1], has_bias and need[2]])
        return gx, gw, gb, None, None, None, None


def conv2d_f64_forward(x, weight, bias, stride, padding, dilation, groups):
    """``F.conv2d`` of fp32 operands with the forward computed in float64
    and rounded once to fp32 (``_F64Forward``); raises for operands of any
    other dtype. Counts its calls in ``conv2d_f64_forward.calls``."""
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise TypeError(f"conv2d_f64_forward takes fp32 operands, not "
                        f"{x.dtype} and {weight.dtype}")
    conv2d_f64_forward.calls += 1
    return _F64Forward.apply(x, weight, bias, stride, padding, dilation,
                             groups)


conv2d_f64_forward.calls = 0


class F64ForwardConv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters, names and state dict) whose forward
    in an fp32 training step (``training_numerics(False)``) with an fp32
    input is ``conv2d_f64_forward``, on every device: each output the
    float64 result rounded once.

    The discriminator's convolutions are these. Each feeds a LeakyReLU
    (through a BatchNorm in the four strided blocks), whose slope changes
    at zero, and train-mode BatchNorm's bias gradient is a sum that
    cancels: an output that fp32 rounding moves across the kink moves that
    gradient by its whole term. cuDNN's fp32 forward (FFMA, no TF32) lies
    about twice as far from float64 as the CPU's fp32 forward: neither
    loses bits, yet on some inputs a BatchNorm output lies within either
    distance of the kink, and the card and the CPU move different inputs
    across it. A bf16 step and a forward outside a training step run
    ``nn.Conv2d``'s forward.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _F64_FORWARD["on"] and x.dtype == torch.float32:
            return conv2d_f64_forward(x, self.weight, self.bias, self.stride,
                                      self.padding, self.dilation,
                                      self.groups)
        return super().forward(x)


def select_devices(opt) -> list:
    """The devices ``opt['device_ids']`` names for this process.

    ``[]`` is an explicit CPU run; ids map to ``cuda:<id>`` and must exist
    (an id may repeat: row-sharded inference then runs its shards on one
    card); no ids means ``cuda:0``. In a data-parallel run each rank takes
    its own device (``parallel.dist.rank_device``). Without CUDA and
    without an explicit ``[]`` this raises rather than running on the CPU.
    """
    ids = opt.get("device_ids")
    if ids is not None and len(ids) == 0:
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set device_ids: [] to run on "
                           "the CPU explicitly")
    count = torch.cuda.device_count()
    bad = [i for i in ids or [] if i >= count or i < 0]
    if bad:
        raise ValueError(f"device ids {bad} out of range: only {count} "
                         f"devices available")
    if dist.world() > 1:
        return [dist.rank_device(ids)]
    return [torch.device("cuda", i) for i in (ids or [0])]


def select_device(opt) -> torch.device:
    """The first of ``select_devices(opt)``: the device a model's weights
    live on."""
    return select_devices(opt)[0]
