"""Seeded weights and inputs, made on the device in a few large draws.

A network's weights are one uniform draw on the device, split into its
convolution and linear leaves, each scaled to torch's default bound
U(+-1/sqrt(fan_in)) with fan_in = weight[0].numel(); BatchNorm starts at
scale 1, bias 0 and fresh running statistics. The state dict is keyed by
the published names, which the program and the reference both load.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number up
    to 2**64 - 1; a negative one is taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 64)
    return g


def random_state(module: nn.Module, gen: torch.Generator, device) -> dict:
    """A fp32 state dict for ``module``'s layout (``module`` may live on the
    meta device), drawn from ``gen`` in one call."""
    leaves = []
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            leaves.append((f"{name}.weight", tuple(m.weight.shape), bound))
            if m.bias is not None:
                leaves.append((f"{name}.bias", tuple(m.bias.shape), bound))
    total = sum(math.prod(s) for _, s, _ in leaves)
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    sd, off = {}, 0
    for name, shape, bound in leaves:
        k = math.prod(shape)
        sd[name] = u[off:off + k].view(shape).mul_(bound)
        off += k
    for name, m in module.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            sd[f"{name}.weight"] = torch.ones(c, device=device)
            sd[f"{name}.bias"] = torch.zeros(c, device=device)
            sd[f"{name}.running_mean"] = torch.zeros(c, device=device)
            sd[f"{name}.running_var"] = torch.ones(c, device=device)
            sd[f"{name}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    return sd


def layout(cls, *args, **kwargs) -> nn.Module:
    """An instance of ``cls`` on the meta device: shapes only."""
    with torch.device("meta"):
        return cls(*args, **kwargs)
