"""On-device output quantisation (``tecogan_tpu/models/networks/frnet.py``
lines 799-803)."""

from __future__ import annotations

import torch

__all__ = ["quantize_uint8"]


def quantize_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8: ``clip(round(x * 255), 0, 255)`` in fp32.

    ``torch.round`` rounds half to even, like ``jnp.round``.
    """
    return torch.clamp(torch.round(x.float() * 255.0), 0, 255).to(torch.uint8)
