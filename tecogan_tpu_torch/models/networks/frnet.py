"""FRNet — frame-recurrent generator (FNet + SRNet): the training unroll and
streaming inference.

Port of ``tecogan_tpu/models/networks/frnet.py``. Training
(``forward_sequence``): FNet runs once over the clip's t-1 (cur, prev)
pairs, the flows are upsampled to HR, and a per-frame recurrence warps the
previous HR frame with the differentiable warp (``ops/warp_vjp.py``: K2
forward, K3/K4 backward) and reconstructs the frame with SRNet; frame 0
warps a zero HR carry along a zero flow. Inference: per
chunk of frames, FNet runs batched over the chunk's (cur, prev) LR pairs,
the LR flow is reflect-padded back to the LR size and upsampled to an HR
flow, then a per-frame loop warps the previous HR frame
(``ops/warp_cuda.py::warp_planes``, the CUDA kernel on a card) and
reconstructs the current frame with SRNet. Outputs are quantised to uint8
on the device. Two opt-in layouts of the same recurrence give the same
outputs: ``FRNetConfig.packed16`` warps the HR frame's phase planes to
per-phase f32 coordinates (K5, ``ops/warp_phases.py``), writing conv_in's
space_to_depth input directly; ``fold_streams`` stacks the streams along
rows with guard rows between them and runs a batch-1 recurrence with K1 in
band mode and a row-masked SRNet.

bf16 mode (``compute_dtype="bfloat16"``) casts weights and inputs to bf16;
resampling matrices follow the activation dtype, so the HR flow is bf16.
The warp keeps fp32 coordinates and taps, and quantisation is fp32.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ...nn import init_torch_default
from ...ops.color import quantize_uint8
from ...ops.resize import get_upsampling_fn, resize_matrix, upsample_mode
from ...ops.spatial import space_to_depth
from ...ops.warp_cuda import warp_planes
from ...ops.warp_phases import phase_planes, warp_phases
from ...ops.warp_vjp import backward_warp_diff
from ...utils import tracing
from .fnet import FNet
from .srnet import SRNet

__all__ = ["FRNetConfig", "FRNet", "forward_sequence", "infer_sequence",
           "infer_sequence_batch", "stream_frames"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class FRNetConfig:
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 64
    nb: int = 10
    scale: int = 4
    degradation: str = "BD"
    # recompute each training frame's step in the backward pass
    # (torch.utils.checkpoint) so BPTT keeps one frame's activations per
    # frame instead of all of them
    remat: bool = True
    # inference precision: 'float32' | 'bfloat16'
    compute_dtype: str = "float32"
    # streaming inference on the HR frame's phase planes (K5) with f32
    # per-phase coordinates, instead of the HR frame (K1) along the HR flow
    packed16: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def _reflect_pad_flow(flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Reflect-pad an (n, 2, h8, w8) flow up to (n, 2, h, w): FNet's pools
    floor sizes to multiples of 8 (`tecogan_nets.py:239-241`)."""
    ph, pw = h - flow.shape[-2], w - flow.shape[-1]
    if ph == 0 and pw == 0:
        return flow
    return F.pad(flow, (0, pw, 0, ph), mode="reflect")


class FRNet(nn.Module):
    """FNet + SRNet with the reference's state-dict names (``fnet.*``,
    ``srnet.*``). Build with ``FRNet.random`` or ``FRNet.from_state_dict``,
    which construct on the meta device and then fill the weights."""

    def __init__(self, cfg: FRNetConfig):
        super().__init__()
        self.cfg = cfg
        self.fnet = FNet(cfg.in_nc)
        self.srnet = SRNet(cfg.in_nc, cfg.out_nc, cfg.nf, cfg.nb, cfg.scale,
                           cfg.degradation)

    @classmethod
    def random(cls, cfg: FRNetConfig, generator: torch.Generator,
               device: torch.device | str = "cpu") -> "FRNet":
        """Weights drawn from ``generator`` (a CPU generator) with torch's
        default bounds, then moved to ``device``; fp32."""
        with torch.device("meta"):
            net = cls(cfg)
        net = net.to_empty(device="cpu")
        init_torch_default(net, generator)
        return net.to(device).eval()

    @classmethod
    def from_state_dict(cls, cfg: FRNetConfig, state_dict,
                        device: torch.device | str = "cpu") -> "FRNet":
        """Weights from a state dict in the reference's names (tensors or
        numpy arrays), copied, so training the net leaves the caller's
        arrays as they are; missing, extra or misshapen entries raise."""
        with torch.device("meta"):
            net = cls(cfg)
        sd = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32,
                                       copy=True)
              for k, v in state_dict.items()}
        net.load_state_dict(sd, strict=True, assign=True)
        return net.eval()

    def hr_flow(self, lr_flow: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """LR flow (n, 2, h8, w8) -> HR flow (n, 2, s*h, s*w): reflect pad to
        the LR size, upsample, scale the velocities."""
        lr_flow = _reflect_pad_flow(lr_flow, h, w)
        return self.cfg.scale * self.srnet.upsample(lr_flow)

    def step(self, lr_curr: torch.Tensor, lr_prev: torch.Tensor,
             hr_prev: torch.Tensor) -> torch.Tensor:
        """One streaming step in NCHW: (n, c, h, w) x2 + (n, c, sh, sw) ->
        (n, c, sh, sw) (reference single-frame path,
        `tecogan_nets.py:227-252`)."""
        h, w = lr_curr.shape[-2:]
        flow = self.hr_flow(self.fnet(lr_curr, lr_prev), h, w)
        warped = warp_planes(hr_prev, flow.permute(0, 2, 3, 1))
        return self.srnet(lr_curr, warped)


def _sub_params(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _sr_step(srnet: SRNet, srnet_params: dict, lr_curr: torch.Tensor,
             hr_prev: torch.Tensor, hr_flow: torch.Tensor) -> torch.Tensor:
    """One training recurrence step in NCHW, the reference form: warp the
    previous HR frame along the (n, H, W, 2) flow, then SRNet on
    cat(lr, space_to_depth(warped)) with ``srnet_params``."""
    hr_warp = backward_warp_diff(hr_prev, hr_flow)
    return functional_call(srnet, srnet_params, (lr_curr, hr_warp))


def forward_sequence(net: FRNet, lr_data: torch.Tensor, cfg: FRNetConfig,
                     params: dict | None = None) -> dict:
    """Run the full training unroll.

    Args:
        net: the FRNet whose modules run.
        lr_data: (n, t, h, w, c) LR clip, h and w multiples of 8.
        params: tensors in ``net.state_dict()``'s names to run with in
            place of the module's own (e.g. bf16 copies of its fp32
            parameters); gradients flow back through them.

    Returns (the JAX package's layouts, as views of NCHW tensors):
        hr_data: (n, t, s*h, s*w, c)
        hr_flow: (n, t-1, s*h, s*w, 2)
        lr_prev/lr_curr: (n*(t-1), h, w, c)
        lr_flow: (n*(t-1), h, w, 2)
    """
    n, t, h, w, c = lr_data.shape
    s = cfg.scale
    if params is None:
        params = dict(net.named_parameters())
    x = lr_data.permute(0, 1, 4, 2, 3).contiguous()  # (n, t, c, h, w)

    lr_prev = x[:, :-1].reshape(n * (t - 1), c, h, w)
    lr_curr = x[:, 1:].reshape(n * (t - 1), c, h, w)
    lr_flow = functional_call(net.fnet, _sub_params(params, "fnet."),
                              (lr_curr, lr_prev))
    hr_flow = net.hr_flow(lr_flow, h, w).reshape(n, t - 1, 2, s * h, s * w)

    # frame 0 warps a zero HR carry along a zero flow, the reference's
    # zero-state first step; both are constants, so its warp has no
    # backward
    flows = [torch.zeros((n, s * h, s * w, 2), dtype=hr_flow.dtype,
                         device=hr_flow.device)]
    flows += [f.permute(0, 2, 3, 1) for f in hr_flow.unbind(1)]
    step = functools.partial(_sr_step, net.srnet,
                             _sub_params(params, "srnet."))
    hr_prev = torch.zeros((n, cfg.out_nc, s * h, s * w), dtype=x.dtype,
                          device=x.device)
    hrs = []
    for i in range(t):
        if cfg.remat:
            hr_prev = checkpoint(step, x[:, i], hr_prev, flows[i],
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            hr_prev = step(x[:, i], hr_prev, flows[i])
        hrs.append(hr_prev)

    return {
        "hr_data": torch.stack(hrs, dim=1).permute(0, 1, 3, 4, 2),
        "hr_flow": hr_flow.permute(0, 1, 3, 4, 2),
        "lr_prev": lr_prev.permute(0, 2, 3, 1),
        "lr_curr": lr_curr.permute(0, 2, 3, 1),
        "lr_flow": lr_flow.permute(0, 2, 3, 1),
    }


def _compute_module(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``net`` in ``dtype``: itself when it already is, else a cast copy
    (the caller's module is never modified)."""
    if next(net.parameters()).dtype == dtype:
        return net
    return copy.deepcopy(net).to(dtype)


def _phase_flow_coords(cfg: FRNetConfig, lr_flow: torch.Tensor, h: int,
                       w: int):
    """Per-phase clamped absolute HR sample coordinates straight from the LR
    flow (n, 2, h8, w8): sy, sx (n, s*s, h, w), f32 whatever the flow's
    dtype. Phase q = py*s + px of the f32 HR flow is its rows py::s and
    columns px::s (port of
    ``tecogan_tpu/models/networks/frnet.py::_phase_flow_coords``, which
    applies the matching rows of the upsampling operator phase by phase)."""
    s = cfg.scale
    up = get_upsampling_fn(s, cfg.degradation)
    f = s * up(_reflect_pad_flow(lr_flow, h, w).float())
    # (n, 2, py, px, h, w): a view, velocities scaled to HR
    f = f.unflatten(2, (h, s)).unflatten(4, (w, s)).permute(0, 1, 3, 5, 2, 4)
    dev = f.device
    p = torch.arange(s, dtype=torch.float32, device=dev)
    ii = s * torch.arange(h, dtype=torch.float32, device=dev)
    jj = s * torch.arange(w, dtype=torch.float32, device=dev)
    sy = torch.clamp(p[:, None, None, None] + ii[:, None] + f[:, 1], 0.0,
                     s * h - 1.0)
    sx = torch.clamp(p[:, None, None] + jj + f[:, 0], 0.0, s * w - 1.0)
    return sy.flatten(1, 2), sx.flatten(1, 2)


def _fold_geometry(scale: int, h: int):
    """Per-stream row pitch of the folded layout: ``g`` guard rows (at
    least 2) bumped until the HR band s*(h+g) is a multiple of 32, as the
    JAX package's banded warp needs. Returns (g, LR pitch, HR band)."""
    g = 2
    while (scale * (h + g)) % 32:
        g += 1
    ph = h + g
    return g, ph, scale * ph


def _fold_masks(scale: int, n: int, h: int, ph: int, band: int,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str = "cpu") -> dict:
    """0/1 guard-row masks (1, 1, rows, 1) of the folded layout: ``lr``
    (LR rows, pitch ph), ``up`` (2x rows, pitch band/2) and ``planes`` (HR
    rows, pitch band)."""
    def m(pitch, valid):
        r = torch.arange(n * pitch, device=device)
        return (r % pitch < valid).to(dtype).reshape(1, 1, n * pitch, 1)

    return {"lr": m(ph, h), "up": m(band // 2, scale * h // 2),
            "planes": m(band, scale * h)}


def _fold_residual_mh(cfg: FRNetConfig, n: int, h: int,
                      ph: int) -> np.ndarray:
    """Block-diagonal vertical residual operator (n*s*ph, n*ph) of the
    folded layout: each stream's (s*h, h) upsampling matrix on the
    diagonal, zero at the guard rows and columns, so streams do not mix."""
    s = cfg.scale
    mh = resize_matrix(upsample_mode(cfg.degradation), h, scale=s)
    big = np.zeros((n * s * ph, n * ph), np.float32)
    for b in range(n):
        big[b * s * ph:b * s * ph + s * h, b * ph:b * ph + h] = mh
    return big


def _chunk_frames(net: FRNet, cfg: FRNetConfig, cur, lr_flow, hr_prev,
                  out):
    """The default recurrence over one chunk: K1 warps the HR frame along
    the HR flow. cur (n, chunk, c, h, w), lr_flow (n*chunk, 2, h8, w8),
    hr_prev (n, c, s*h, s*w); appends each frame's uint8 (n, s*h, s*w, c)
    to the list ``out`` and returns the last HR frame."""
    n, chunk, _, h, w = cur.shape
    s = cfg.scale
    hr_flow = net.hr_flow(lr_flow, h, w).reshape(n, chunk, 2, s * h, s * w)
    for i in range(chunk):
        warped = warp_planes(hr_prev, hr_flow[:, i].permute(0, 2, 3, 1))
        hr_prev = net.srnet(cur[:, i], warped)
        out.append(quantize_uint8(hr_prev).permute(0, 2, 3, 1))
    return hr_prev


def _chunk_phases(net: FRNet, cfg: FRNetConfig, cur, lr_flow, hr_prev,
                  out):
    """The packed16 recurrence over one chunk (arguments as
    ``_chunk_frames``): K5 warps the previous HR frame's phase planes (a
    view, no copy) to the f32 per-phase coordinates and writes conv_in's
    space_to_depth input, which SRNet takes as it is."""
    n, chunk, _, h, w = cur.shape
    s = cfg.scale
    sy, sx = _phase_flow_coords(cfg, lr_flow, h, w)
    sy = sy.reshape(n, chunk, s * s, h, w)
    sx = sx.reshape(n, chunk, s * s, h, w)
    for i in range(chunk):
        warped = warp_phases(phase_planes(hr_prev, s), sy[:, i], sx[:, i], s)
        hr_prev = net.srnet.forward_packed(cur[:, i],
                                           warped.transpose(1, 2).flatten(1, 2))
        out.append(quantize_uint8(hr_prev).permute(0, 2, 3, 1))
    return hr_prev


def _chunk_folded(net: FRNet, cfg: FRNetConfig, fold: dict, cur, lr_flow,
                  hr_prev, out):
    """The row-folded recurrence over one chunk (arguments as
    ``_chunk_frames``, but hr_prev is the folded (1, c, n*band, s*w)
    frame): stream b's rows start at row b*band of every folded tensor
    (b*ph at LR), followed by zero guard rows. K1 warps in band mode, the
    guard rows of the warped frame are zeroed, and SRNet runs row-masked
    with the block-diagonal residual."""
    n, chunk, c, h, w = cur.shape
    s = cfg.scale
    ph, band, masks = fold["ph"], fold["band"], fold["masks"]
    hr_flow = net.hr_flow(lr_flow, h, w).reshape(n, chunk, 2, s * h, s * w)
    flow_f = F.pad(hr_flow, (0, 0, 0, band - s * h)).permute(
        1, 2, 0, 3, 4).reshape(chunk, 2, n * band, s * w)
    lr_f = F.pad(cur, (0, 0, 0, ph - h)).permute(1, 2, 0, 3, 4).reshape(
        chunk, c, n * ph, w)
    for i in range(chunk):
        warped = warp_planes(hr_prev, flow_f[i].permute(1, 2, 0)[None],
                             band=band, band_valid=s * h)
        hr_prev = net.srnet.forward_packed(
            lr_f[i:i + 1], space_to_depth(warped * masks["planes"], s),
            row_masks=masks, residual_mh=fold["mh"])
        hr = hr_prev.reshape(cfg.out_nc, n, band, s * w)[:, :, :s * h]
        out.append(quantize_uint8(hr).permute(1, 2, 3, 0))
    return hr_prev


def infer_sequence_batch(net, lr_seqs: torch.Tensor, cfg: FRNetConfig,
                         chunk: int = 16,
                         fold_streams: bool = False) -> torch.Tensor:
    """SR a batch of LR sequences: (n, t, h, w, c) float -> uint8
    (n, t, s*h, s*w, c), on the device ``net`` lives on.

    ``net`` is an ``FRNet`` or a state dict in its names. Chunks are
    balanced to the length (``ceil(t / n_chunks)`` frames each) and the
    last is edge-padded by repeating the final frame; the padded outputs
    are trimmed. The LR-prev and HR carries start at zeros; across chunks
    the LR-prev carry is the chunk's last frame. FNet runs batched over a
    chunk's frame pairs of every stream.

    The recurrence takes one of three layouts, with the same outputs:
    the default (K1 on the HR frame); ``cfg.packed16`` (K5 on its phase
    planes); ``fold_streams`` (the n streams stacked along rows as one
    batch-1 frame, K1 in band mode; it takes precedence over packed16).
    Each runs its kernel on CUDA tensors and its plain version on CPU ones.
    """
    lr_seqs = torch.as_tensor(lr_seqs)
    if not isinstance(net, nn.Module):
        net = FRNet.from_state_dict(cfg, net, device=lr_seqs.device)
    net = _compute_module(net, cfg.dtype)
    with torch.inference_mode():
        return stream_frames(net, lr_seqs, cfg, chunk, fold_streams)


def stream_frames(net: FRNet, lr_seqs: torch.Tensor, cfg: FRNetConfig,
                  chunk: int = 16, fold_streams: bool = False
                  ) -> torch.Tensor:
    """``infer_sequence_batch``'s recurrence on a net already in the compute
    dtype, with no mode of its own: the function a serving program traces
    (``serving.export_stream``). Each frame's uint8 output is kept as it is
    made and the frames are stacked once at the end, so a trace holds no
    in-place write into a slice of the output. While a profiler records,
    each chunk is the span ``tecogan.infer.chunk`` over ``infer.fnet``
    (FNet on the chunk's frame pairs) and ``infer.recurrence`` (its warps,
    SRNet and quantisation); no span is per frame."""
    dt = cfg.dtype
    device = next(net.parameters()).device
    n, t, h, w, c = lr_seqs.shape
    s = cfg.scale
    # (n, t, c, h, w) in the compute dtype
    x = lr_seqs.to(device=device, dtype=dt).permute(0, 1, 4, 2, 3)
    n_chunks = -(-t // chunk)
    chunk = -(-t // n_chunks)
    pad = n_chunks * chunk - t
    if pad:
        x = torch.cat([x, x[:, -1:].expand(n, pad, c, h, w)], dim=1)

    if fold_streams:
        _, ph, band = _fold_geometry(s, h)
        fold = {"ph": ph, "band": band,
                "masks": _fold_masks(s, n, h, ph, band, dt, device),
                "mh": torch.from_numpy(_fold_residual_mh(
                    cfg, n, h, ph)).to(device=device, dtype=dt)}
        run = functools.partial(_chunk_folded, net, cfg, fold)
        hr_prev = torch.zeros((1, cfg.out_nc, n * band, s * w), dtype=dt,
                              device=device)
    else:
        run = functools.partial(
            _chunk_phases if cfg.packed16 else _chunk_frames, net, cfg)
        hr_prev = torch.zeros((n, cfg.out_nc, s * h, s * w), dtype=dt,
                              device=device)
    lr_prev = torch.zeros((n, c, h, w), dtype=dt, device=device)
    frames = []
    for k in range(n_chunks):
        with tracing.span("infer.chunk"):
            cur = x[:, k * chunk:(k + 1) * chunk]
            prevs = torch.cat([lr_prev[:, None], cur[:, :-1]], dim=1)
            with tracing.span("infer.fnet"):
                lr_flow = net.fnet(cur.reshape(n * chunk, c, h, w),
                                   prevs.reshape(n * chunk, c, h, w))
            with tracing.span("infer.recurrence"):
                hr_prev = run(cur, lr_flow, hr_prev, frames)
            lr_prev = cur[:, -1]
    return torch.stack(frames[:t], dim=1)


def infer_sequence(net, lr_seq: torch.Tensor, cfg: FRNetConfig,
                   chunk: int = 16) -> torch.Tensor:
    """SR one LR sequence: (t, h, w, c) -> uint8 (t, s*h, s*w, c)."""
    return infer_sequence_batch(net, lr_seq[None], cfg, chunk)[0]
