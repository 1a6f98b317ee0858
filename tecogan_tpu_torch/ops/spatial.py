"""Space<->depth shuffles for NCHW data.

Port of ``tecogan_tpu/ops/spatial.py``. The packed channel order is the
reference's: channel ``(dy * s + dx) * c + ch`` holds input channel ``ch``
at block offset (dy, dx) — the reference's NCHW permute (0, 3, 5, 1, 2, 4).
``F.pixel_unshuffle`` orders channels ``ch * s * s + dy * s + dx`` instead,
which would scramble conv_in's HR channels against every JAX or ``.pth``
weight, so it is not used.
"""

from __future__ import annotations

import torch

__all__ = ["space_to_depth", "depth_to_space"]


def space_to_depth(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(n, c, h, w) -> (n, s*s*c, h/s, w/s), block offsets leading."""
    n, c, h, w = x.shape
    s = scale
    x = x.reshape(n, c, h // s, s, w // s, s)
    # (n, c, oh, dy, ow, dx) -> (n, dy, dx, c, oh, ow)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, s * s * c, h // s, w // s)


def depth_to_space(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, c2, h, w = x.shape
    s = scale
    c = c2 // (s * s)
    x = x.reshape(n, s, s, c, h, w)
    # (n, dy, dx, c, h, w) -> (n, c, h, dy, w, dx)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * s, w * s)
