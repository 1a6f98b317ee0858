"""Layer helpers (the port of ``tecogan_tpu/nn.py``'s ``cast_params`` and
``batch_norm``), the devices a run takes and the numerics inference runs
under. Its ``leaky_relu`` and ``max_pool_2x2`` are torch's
``nn.LeakyReLU(0.2)`` and ``nn.MaxPool2d(2, 2)`` (floor semantics), which
the networks hold as modules in the reference's layout."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from .parallel import dist

__all__ = ["cast_params", "batch_norm", "inference_numerics",
           "init_torch_default", "select_device", "select_devices"]


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
