"""Layer helpers (the port of ``tecogan_tpu/nn.py``'s ``cast_params`` and
``batch_norm``). Its ``leaky_relu`` and ``max_pool_2x2`` are torch's
``nn.LeakyReLU(0.2)`` and ``nn.MaxPool2d(2, 2)`` (floor semantics), which
the networks hold as modules in the reference's layout."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["cast_params", "batch_norm", "init_torch_default"]


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
