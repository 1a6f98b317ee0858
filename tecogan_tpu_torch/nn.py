"""Parameter helpers (the port of ``tecogan_tpu/nn.py::cast_params``)."""

from __future__ import annotations

import torch

__all__ = ["cast_params"]


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Cast the floating tensors of a name -> tensor dict to ``dtype``.

    The casts are differentiable copies: a forward run on them (through
    ``torch.func.functional_call``) sends its gradients back, in fp32, to
    the fp32 master parameters they were cast from. Other tensors pass
    through unchanged.
    """
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}
