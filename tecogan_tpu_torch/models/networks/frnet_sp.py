"""Row-sharded single-stream inference: one video stream's rows spread over
several devices (port of ``tecogan_tpu/models/networks/frnet_sp.py``).

Use case: single-stream latency on large frames, where batching more
streams onto one card cannot help. The JAX package runs it as one
``shard_map`` program over an ``sp`` mesh; here one process drives a list
of k devices, and shard j owns LR rows ``[j*v, (j+1)*v)``, ``v = h / k``.

Decomposition (overlap-and-discard, exact by construction), the JAX
package's window arithmetic unchanged:

- Every shard computes an extended row WINDOW of each stage and discards
  the contaminated margin. Windows are clamp-shifted at the global top and
  bottom, so border shards start at the true border and each convolution
  applies its own zero padding there.
- FNet's window carries ``h_fn = h_sr + 96`` halo rows; the LR frame is
  cheap, so every shard slices its windows from the whole LR chunk (the
  JAX package's all-gather).
- The SR step (conv_in, the residual blocks, the upsampling tail and the
  bicubic residual) carries ``h_sr = round8(max(32, 2*nb + 12))`` halo rows.
- The warp reads the previous HR frame at most ``24*s + 1`` rows away, so
  each shard assembles a slab of ``+-b2`` HR rows around its own from the
  neighbours' HR blocks (the JAX package's ``ppermute`` halo exchange; here
  a copy from each neighbour's device, peer to peer between cards), and
  warps it with K1's window mode (``ops/warp_cuda.py::warp_planes_window``),
  which clamps at the GLOBAL border. Rows outside the image are zeros, as
  a ``ppermute`` from no neighbour gives.

Constraints: ``h % k == 0`` and ``(h / k) % 8 == 0`` (FNet's pooling
alignment). ``devices`` may repeat one device: the shards then run in turn
on it, which exercises every window and halo path on one card (and on the
CPU, as the JAX package's tests use virtual CPU meshes). In floating point
the shards agree with ``infer_sequence`` to the convolutions' reduction
order at each window height: uint8 outputs within 1 gray level on <=0.02%
of pixels (``tests/test_sp_inference.py``).
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ...ops.color import quantize_uint8
from ...ops.warp_cuda import warp_planes_window
from .fnet import _MAX_VELOCITY
from .frnet import FRNet, FRNetConfig, _compute_module, infer_sequence

__all__ = ["infer_sequence_sp", "sp_geometry"]


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def sp_geometry(cfg: FRNetConfig, h: int, k: int) -> dict:
    """The windows of a k-shard run on h LR rows (``frnet_sp.py:95-110``):
    rows per shard ``v``, the halos ``h_sr`` and ``h_fn``, the warp's HR
    reach ``b2`` and the shards it spans, ``hops``, the window lengths
    ``l_fn`` and ``l_sr``, and each shard's clamp-shifted window starts
    ``fn_start`` and ``sr_start``. Raises ValueError on misaligned rows."""
    if h % k:
        raise ValueError(f"rows h={h} not divisible by sp mesh size {k}")
    v = h // k
    if v % 8:
        raise ValueError(
            f"rows-per-shard h/k={v} must be a multiple of 8 (FNet "
            "pooling alignment); pad the input or use fewer shards")
    s = cfg.scale
    h_sr = _round8(max(32, 2 * cfg.nb + 12))
    h_fn = h_sr + 96
    reach = _round8(int(_MAX_VELOCITY * s) + 2)  # 97 -> 104 at 4x
    b2 = _round8(2 * s * h_sr + reach)  # border-window reach
    l_fn = min(h, v + 2 * h_fn)
    l_sr = min(h, v + 2 * h_sr)
    rows0 = [j * v for j in range(k)]
    return {"v": v, "h_sr": h_sr, "h_fn": h_fn, "b2": b2,
            "hops": -(-b2 // (s * v)), "l_fn": l_fn, "l_sr": l_sr,
            "fn_start": [min(max(r - h_fn, 0), h - l_fn) for r in rows0],
            "sr_start": [min(max(r - h_sr, 0), h - l_sr) for r in rows0]}


def _slab(hr: list, j: int, geo: dict, s: int, h: int, device) -> torch.Tensor:
    """Shard j's warp slab: global HR rows ``[s*j*v - b2, s*(j+1)*v + b2)``
    from the shards' HR blocks (copies from other devices), zeros outside
    the image."""
    v, b2 = geo["v"], geo["b2"]
    n, c, _, sw = hr[j].shape
    lo, hi = s * j * v - b2, s * (j + 1) * v + b2
    parts = []
    if lo < 0:
        parts.append(hr[j].new_zeros((n, c, -lo, sw)))
    for jj, block in enumerate(hr):
        a, b = max(lo, s * jj * v), min(hi, s * (jj + 1) * v)
        if a < b:
            rows = block[:, :, a - s * jj * v:b - s * jj * v]
            parts.append(rows.to(device, non_blocking=True))
    if hi > s * h:
        parts.append(hr[j].new_zeros((n, c, hi - s * h, sw)))
    return torch.cat(parts, dim=2)


def infer_sequence_sp(net, lr_seq: torch.Tensor, cfg: FRNetConfig, devices,
                      chunk: int = 8) -> torch.Tensor:
    """SR one LR sequence with its rows sharded over ``devices``.

    Args:
        net: an ``FRNet`` (or a state dict in its names); it is copied to
            every other device of the list.
        lr_seq: (t, h, w, c) LR frames in [0, 1]; ``h`` must satisfy
            ``h % (8 * k) == 0`` for k devices.
        devices: k devices, one per shard (a device may repeat).
        chunk: frames per FNet batch, balanced to the length as in
            ``infer_sequence_batch``.

    Returns uint8 (t, s*h, s*w, c) on ``devices[0]``. With one device it
    is ``infer_sequence``.
    """
    devices = [torch.device(d) for d in devices]
    k = len(devices)
    lr_seq = torch.as_tensor(lr_seq)
    if not isinstance(net, nn.Module):
        net = FRNet.from_state_dict(cfg, net, device=devices[0])
    if k == 1:
        return infer_sequence(net, lr_seq.to(devices[0]), cfg, chunk)
    t, h, w, c = lr_seq.shape
    geo = sp_geometry(cfg, h, k)
    nets = replicas(net, cfg, devices)
    with torch.inference_mode():
        return _stream_rows(nets, devices, lr_seq, cfg, geo, chunk)


def replicas(net, cfg: FRNetConfig, devices) -> dict:
    """{device: ``net`` in the compute dtype on it}, one copy per distinct
    device (the net itself where it already lives)."""
    net = _compute_module(net, cfg.dtype)
    nets = {}
    for d in devices:
        if d not in nets:
            on = next(net.parameters()).device == d
            nets[d] = net if on else copy.deepcopy(net).to(d)
    return nets


def _stream_rows(nets, devices, lr_seq, cfg, geo, chunk):
    """The sharded recurrence (``frnet_sp.py:112-193``)."""
    k = len(devices)
    dt = cfg.dtype
    t, h, w, c = lr_seq.shape
    s, v = cfg.scale, geo["v"]
    l_fn, l_sr, b2 = geo["l_fn"], geo["l_sr"], geo["b2"]
    x = lr_seq.to(device=devices[0], dtype=dt).permute(0, 3, 1, 2)
    n_chunks = -(-t // chunk)
    chunk = -(-t // n_chunks)
    pad = n_chunks * chunk - t
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, c, h, w)], dim=0)

    hr = [torch.zeros((1, cfg.out_nc, s * v, s * w), dtype=dt, device=d)
          for d in devices]
    lr_prev = torch.zeros((c, h, w), dtype=dt, device=devices[0])
    frames = []
    for kk in range(n_chunks):
        cur = x[kk * chunk:(kk + 1) * chunk]
        prevs = torch.cat([lr_prev[None], cur[:-1]], dim=0)
        flows, lrs = [], []
        for j, d in enumerate(devices):
            net = nets[d]
            cur_d, prev_d = cur.to(d), prevs.to(d)
            fs, ss = geo["fn_start"][j], geo["sr_start"][j]
            lr_flow = net.fnet(cur_d[:, :, fs:fs + l_fn],
                               prev_d[:, :, fs:fs + l_fn])
            flow_sr = lr_flow[:, :, ss - fs:ss - fs + l_sr]
            flows.append(net.hr_flow(flow_sr, l_sr, w).permute(0, 2, 3, 1))
            lrs.append(cur_d[:, :, ss:ss + l_sr])
        for i in range(chunk):
            new = []
            for j, d in enumerate(devices):
                ss = geo["sr_start"][j]
                warped = warp_planes_window(
                    _slab(hr, j, geo, s, h, d), flows[j][i:i + 1],
                    out_y0=s * ss, x_y0=s * j * v - b2, h_glob=s * h)
                hr_ext = nets[d].srnet(lrs[j][i:i + 1], warped)
                keep = s * (j * v - ss)
                new.append(hr_ext[:, :, keep:keep + s * v])
            hr = new
            frames.append(torch.cat(
                [quantize_uint8(b).to(devices[0]) for b in hr],
                dim=2)[0].permute(1, 2, 0))
        lr_prev = cur[-1]
    return torch.stack(frames[:t])
