"""Command-line tools of the port (``python -m tecogan_tpu_torch.tools.<name>``).

Every tool that computes on a device runs on the card unless its caller
asks for the CPU through the ``device`` argument of its function (as the
tests do); ``resolve_device`` raises where there is no card and no such
request, and never falls back to the CPU."""

from __future__ import annotations


def resolve_device(device=None):
    """``device`` as a ``torch.device``: None is the first card, which must
    exist; ``"cpu"`` (or any explicit device) is taken as given."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this tool runs on the card; pass "
                "device='cpu' to its function to run on the CPU explicitly")
        return torch.device("cuda", 0)
    return torch.device(device)
