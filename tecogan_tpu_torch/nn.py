"""Layer helpers (the port of ``tecogan_tpu/nn.py``'s ``cast_params`` and
``batch_norm``), the device a run takes and the numerics inference runs
under. Its ``leaky_relu`` and ``max_pool_2x2`` are torch's
``nn.LeakyReLU(0.2)`` and ``nn.MaxPool2d(2, 2)`` (floor semantics), which
the networks hold as modules in the reference's layout."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["cast_params", "batch_norm", "inference_numerics",
           "init_torch_default", "select_device"]


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast the floating tensors of a name -> tensor dict to ``dtype``.

    The casts are differentiable copies: a forward run on them (through
    ``torch.func.functional_call``) sends its gradients back, in fp32, to
    the fp32 master parameters they were cast from. Other tensors pass
    through unchanged.
    """
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def batch_norm(x: torch.Tensor, running_mean: torch.Tensor,
               running_var: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor, train: bool, momentum: float = 0.1,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (N, H, W) of an (N, C, H, W) tensor, computed in fp32
    for fp32 and bf16 x (float64 stays float64) and cast back to x's dtype.
    In training mode the batch's
    statistics normalise and the fp32 running stats are updated in place
    as torch keeps them: momentum 0.1 toward the batch mean and the
    unbiased batch variance."""
    y = F.batch_norm(x.to(torch.promote_types(x.dtype, torch.float32)),
                     running_mean, running_var, weight, bias, train,
                     momentum, eps)
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
def inference_numerics(compute_dtype: str):
    """The cuDNN and matmul settings inference runs under, restored after.

    fp32 means fp32 and the same every run: PyTorch runs fp32 cuDNN
    convolutions and matmuls in TF32 unless told not to, and cuDNN's
    default fp32 transposed convolutions are not deterministic, so for
    float32 work TF32 is off and cuDNN picks only deterministic algorithms.
    bf16 runs under the settings as they are (it is deterministic without
    them).
    """
    if compute_dtype != "float32":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.deterministic = True
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved


def select_device(opt) -> torch.device:
    """The one device ``opt['device_ids']`` names.

    ``[]`` is an explicit CPU run; ids map to ``cuda:<id>`` and must exist;
    no ids means ``cuda:0``. Without CUDA and without an explicit ``[]``
    this raises rather than running on the CPU.
    """
    ids = opt.get("device_ids")
    if ids is not None and len(ids) == 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; set device_ids: [] to run on "
                           "the CPU explicitly")
    if not ids:
        return torch.device("cuda", 0)
    count = torch.cuda.device_count()
    bad = [i for i in ids if i >= count or i < 0]
    if bad:
        raise ValueError(f"device ids {bad} out of range: only {count} "
                         f"devices available")
    if len(ids) > 1:
        raise NotImplementedError(
            f"multi-device inference is not ported yet; got device_ids {ids}")
    return torch.device("cuda", ids[0])
