"""Loss criteria (port of ``tecogan_tpu/models/losses.py``).

``define_criterion`` maps the YAML criterion blocks to closures
``loss(x, y)`` / ``gan_loss(logits, is_real)``. Every loss casts its inputs
to fp32 first, so bf16 activations are reduced in fp32.
"""

from __future__ import annotations

import torch

__all__ = [
    "charbonnier",
    "cosine_similarity_loss",
    "vanilla_gan_loss",
    "lsgan_loss",
    "define_criterion",
]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    raise NotImplementedError(reduction)


def charbonnier(x, y, eps: float = 1e-6, reduction: str = "mean"):
    """Robust L1: sqrt(diff^2 + eps), eps inside the sqrt and un-squared
    (the reference's `losses.py:31-50`). Accumulates in fp32."""
    d = x.float() - y.float()
    return _reduce(torch.sqrt(d * d + eps), reduction)


def cosine_similarity_loss(x, y, eps: float = 1e-8):
    """1 - mean cosine similarity along the last (channel) axis of NHWC
    data, as the JAX package computes it."""
    x = x.float()
    y = y.float()
    dot = (x * y).sum(-1)
    nx = torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=eps)
    ny = torch.clamp(torch.linalg.vector_norm(y, dim=-1), min=eps)
    return 1.0 - (dot / (nx * ny)).mean()


def _bce_with_logits(logits, target):
    # numerically stable BCEWithLogits (fp32)
    logits = logits.float()
    target = target.float()
    return (torch.clamp(logits, min=0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def vanilla_gan_loss(logits, is_real: bool, reduction: str = "mean"):
    target = torch.full_like(logits, float(bool(is_real)))
    return _reduce(_bce_with_logits(logits, target), reduction)


def lsgan_loss(logits, is_real: bool, reduction: str = "mean"):
    logits = logits.float()
    target = torch.full_like(logits, float(bool(is_real)))
    return _reduce(torch.square(logits - target), reduction)


def define_criterion(crit_opt):
    """YAML criterion block -> callable (None passes through)."""
    if crit_opt is None:
        return None
    ctype = crit_opt["type"]
    red = crit_opt.get("reduction", "mean")
    if ctype == "MSE":
        return lambda x, y: _reduce(torch.square(x.float() - y.float()), red)
    if ctype == "L1":
        return lambda x, y: _reduce((x.float() - y.float()).abs(), red)
    if ctype == "CB":
        return lambda x, y: charbonnier(x, y, reduction=red)
    if ctype == "CosineSimilarity":
        return cosine_similarity_loss
    if ctype == "GAN":
        return lambda logits, is_real: vanilla_gan_loss(logits, is_real, red)
    if ctype == "LSGAN":
        return lambda logits, is_real: lsgan_loss(logits, is_real, red)
    raise ValueError(f"Unrecognized criterion: {ctype}")
