"""Stream-split batched inference: the JAX package's ``infer_sequence_batch``
with its batch sharded over the ``dp`` mesh (``P("dp")``,
``tecogan_tpu/parallel/mesh.py:108-110``), on a list of devices."""

from __future__ import annotations

import torch

from ..models.networks.frnet import FRNetConfig, infer_sequence_batch
from ..models.networks.frnet_sp import replicas

__all__ = ["infer_streams"]


def infer_streams(net, lr_seqs: torch.Tensor, cfg: FRNetConfig, devices,
                  chunk: int = 16) -> torch.Tensor:
    """SR a batch of LR sequences with the stream axis split over
    ``devices``.

    Args:
        net: an ``FRNet``; it is copied to every other device of the
            list.
        lr_seqs: (n, t, h, w, c) LR frames in [0, 1]; ``n`` must be a
            multiple of the number of devices.
        devices: k devices; device j runs streams ``j*n/k`` to
            ``(j+1)*n/k - 1`` (contiguous blocks, as ``P("dp")`` lays out
            the batch). A device may repeat: its blocks run in turn.
        chunk: frames per FNet batch, as in ``infer_sequence_batch``.

    Returns uint8 (n, t, s*h, s*w, c) on ``devices[0]``. With one device it
    is ``infer_sequence_batch``.
    """
    devices = [torch.device(d) for d in devices]
    k = len(devices)
    n = lr_seqs.shape[0]
    if n % k:
        raise ValueError(f"{n} streams do not split over {k} devices")
    nets = replicas(net, cfg, devices)
    b = n // k
    outs = [infer_sequence_batch(nets[d], lr_seqs[j * b:(j + 1) * b].to(d),
                                 cfg, chunk)
            for j, d in enumerate(devices)]
    return torch.cat([o.to(devices[0]) for o in outs])
