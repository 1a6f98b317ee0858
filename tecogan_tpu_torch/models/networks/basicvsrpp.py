"""BasicVSR++ — whole-clip bidirectional propagation with second-order
flow-guided deformable alignment (Chan, Zhou, Xu, Loy, "BasicVSR++:
Improving Video Super-Resolution with Enhanced Propagation and
Alignment", CVPR 2022; mmagic's ``basicvsr_plusplus_net.py``), 4x from a
low-resolution clip. Inference only; the JAX package has no counterpart.

For a clip of t LR frames (LeakyReLU slope 0.1 throughout, ReLU inside
the residual blocks; ``RB(cin, m, k)`` is a 3x3 conv cin -> m, LeakyReLU
and k of SRNet's ``ResidualBlock``):

- ``spatial[i] = RB(3, m, 5)(lr_i)``;
- SPyNet flows ``flows_backward[i] = SPyNet(lr_i, lr_{i+1})`` and
  ``flows_forward[i] = SPyNet(lr_{i+1}, lr_i)``, (n, 2, h, w) fp32 with
  (x, y) channels;
- four branches, backward_1, forward_1, backward_2, forward_2, each over
  every frame (backward ones from the last frame down); at each step after
  the first the carried feature is aligned to the frame from it (``f1``)
  and from the feature two steps back (``f2 = f1 + warp(g, f1)``) by the
  flow-guided DCNv2 (``ops/dcn.py``), then ``prop += RB((2 + j) m, m,
  nb)(cat[spatial, the earlier branches' outputs, prop])``;
- per frame ``RB(5 m, m, 5)`` of the five features, two pixel-shuffle
  upsamplings, conv_hr, conv_last, plus the bilinear 4x LR frame,
  quantised to uint8 on the device.

The clip runs whole (the backward branches need its last frame first), so
``infer_clip_batch`` holds every frame's five feature maps of every clip:
(5 m) channels of n t LR frames. Its frame loops run in chunks of
``chunk`` frames of all n clips (the spatial features, SPyNet, the
reconstruction); the branches take one frame of the n clips a step.

Numerics: the network's convolutions run in ``compute_dtype``; the
sampling coordinates (flows, their sums, the DCN's offsets) are computed
and held in fp32, and the output frame is summed in fp32 before it is
quantised. In bf16 the activations and convolution weights are
channels_last (``nn.LayoutFollowsDtype``), as FNet's and SRNet's are;
in fp32 NCHW. Each convolution with its activation or its residual
block's skip is one ``nn.conv_act``: in bf16 inference on a card the bias,
the activation and the skip are one kernel after cuDNN
(``ops.conv_epilogue``). The feature and flow warps take zero padding (K1's
zero-padding instantiation, ``ops/warp_cuda.py::warp_zero``); SPyNet's
own warps take K1 with border padding, as FRNet's do.

Parameter names are mmagic's, but for SRNet's residual blocks
(``conv.0``/``conv.2`` for mmagic's ``conv1``/``conv2``): ``from_state_dict``
and ``read_state_dict`` take mmagic's names and map them (``port_key``).

While a profiler records, the clip's SPyNet runs in the span
``tecogan.infer.flow``, each branch in ``infer.propagate`` (args: its
index), each aligned frame step in ``infer.align`` (its warps, conv_offset
and the DCN) with the DCN alone in ``infer.dcn``, and each chunk's
reconstruction in ``infer.reconstruct``.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import (LayoutFollowsDtype, cat_channels, conv_act, conv_format,
                   init_torch_default, run_fused)
from ...ops.color import quantize_uint8
from ...ops.dcn import modulated_deform_conv
from ...ops.warp_cuda import warp_planes, warp_zero
from ...utils import tracing
from .frnet import _compute_module
from .srnet import ResidualBlock

__all__ = ["BRANCHES", "BasicVSRPP", "BasicVSRPPConfig", "infer_clip_batch",
           "port_key", "read_state_dict"]

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# SPyNet's input normalisation (ImageNet's mean and std)
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
_SPYNET_LEVELS = 6
_RELU = nn.ReLU()


@dataclasses.dataclass(frozen=True)
class BasicVSRPPConfig:
    mid_channels: int = 64
    num_blocks: int = 7
    max_residue_magnitude: float = 10.0
    deform_groups: int = 16
    # inference precision: 'float32' | 'bfloat16'
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, 1, k // 2)


class _ConvModule(nn.Module):
    """mmcv's ConvModule as SPyNet holds it: ``conv`` (7x7), then ReLU
    unless it is the last."""

    def __init__(self, cin: int, cout: int, relu: bool):
        super().__init__()
        self.conv = _conv(cin, cout, 7)
        self.relu = relu

    def forward(self, x):
        return conv_act(self.conv, x, _RELU if self.relu else None)


class SPyNetBasicModule(nn.Module):
    """One pyramid level: 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2."""

    def __init__(self):
        super().__init__()
        chans = (8, 32, 64, 32, 16, 2)
        self.basic_module = nn.Sequential(*[
            _ConvModule(chans[i], chans[i + 1], i < 4) for i in range(5)])

    def forward(self, x):
        return self.basic_module(x)


@functools.lru_cache(maxsize=8)
def _normalisation(device: torch.device):
    """SPyNet's mean and std as (3, 1, 1) fp32 tensors on ``device``, made
    once: a tensor built from a list on a card is a host-to-device copy
    that waits for the device's queue to drain, and SPyNet runs twice a
    chunk."""
    return (torch.tensor(_MEAN, device=device)[:, None, None],
            torch.tensor(_STD, device=device)[:, None, None])


class SPyNet(nn.Module):
    """The flow from ``ref`` to ``supp`` (fp32 (N, 3, h, w) in [0, 1]):
    both resized to multiples of 32 (bilinear, half-pixel), normalised, a
    6-level average-pool pyramid, a zero flow at 1/32 refined level by
    level, ``flow = up(flow) + B_l(cat[ref_l, warp(supp_l, up(flow)),
    up(flow)])`` with ``up`` the 2x bilinear (align_corners) upsampling
    doubled, then resized back and rescaled. Returns fp32 (N, 2, h, w),
    (x, y) channels, contiguous."""

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(
            [SPyNetBasicModule() for _ in range(_SPYNET_LEVELS)])

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        n, _, h, w = ref.shape
        dt = self.basic_module[0].basic_module[0].conv.weight.dtype
        fmt = conv_format(dt)
        h_up, w_up = -(-h // 32) * 32, -(-w // 32) * 32
        mean, std = _normalisation(ref.device)

        def pyramid(img):
            img = F.interpolate(img, size=(h_up, w_up), mode="bilinear",
                                align_corners=False)
            levels = [(img - mean) / std]
            for _ in range(_SPYNET_LEVELS - 1):
                levels.append(F.avg_pool2d(levels[-1], 2, 2,
                                           count_include_pad=False))
            return levels[::-1]

        refs, supps = pyramid(ref), pyramid(supp)
        flow = torch.zeros((n, 2, h_up // 32, w_up // 32),
                           device=ref.device)
        for level, block in enumerate(self.basic_module):
            if level:
                flow = 2.0 * F.interpolate(flow, scale_factor=2,
                                           mode="bilinear",
                                           align_corners=True)
            warped = warp_planes(supps[level], flow.permute(0, 2, 3, 1))
            inp = cat_channels([t.to(dt) for t in (refs[level], warped, flow)],
                               fmt)
            flow = flow + block(inp).float()
        flow = F.interpolate(flow, size=(h, w), mode="bilinear",
                             align_corners=False)
        return torch.stack([flow[:, 0] * (w / w_up), flow[:, 1] * (h / h_up)],
                           1)


class ResidualBlocksWithInputConv(nn.Module):
    """``RB(cin, m, k)``: a 3x3 conv cin -> m, LeakyReLU(0.1), k residual
    blocks (conv-ReLU-conv + skip)."""

    def __init__(self, cin: int, m: int, blocks: int):
        super().__init__()
        self.main = nn.Sequential(
            _conv(cin, m), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlock(m) for _ in range(blocks)]))

    def forward(self, x):
        return run_fused(self.main, x)


class SecondOrderDeformableAlignment(nn.Conv2d):
    """The DCN's weight (m, 2 m, 3, 3) and bias, and ``conv_offset``:
    3x3 convs (3 m + 4) -> m -> m -> m -> 27 groups with LeakyReLU between
    them, over cat[c1, spatial, c2, f1, f2]."""

    def __init__(self, m: int, groups: int):
        super().__init__(2 * m, m, 3, 1, 1)
        self.conv_offset = nn.Sequential(
            _conv(3 * m + 4, m), nn.LeakyReLU(0.1), _conv(m, m),
            nn.LeakyReLU(0.1), _conv(m, m), nn.LeakyReLU(0.1),
            _conv(m, 27 * groups))


def _pixel_shuffle(x: torch.Tensor, s: int) -> torch.Tensor:
    """``F.pixel_shuffle`` that keeps a channels_last input channels_last
    (one copy, no layout round trip): out[c, s h + dy, s w + dx] =
    in[c s^2 + dy s + dx, h, w]."""
    if x.is_contiguous() or not x.is_contiguous(
            memory_format=torch.channels_last):
        return F.pixel_shuffle(x, s)
    n, cs, h, w = x.shape
    c = cs // (s * s)
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, c, s, s)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(n, h * s, w * s, c).permute(
        0, 3, 1, 2)


class PixelShufflePack(nn.Module):
    """A 3x3 conv m -> 4 m and ``act`` where given (``nn.conv_act``), then
    a 2x pixel shuffle: the activation acts on each value alone, so it
    commutes with the shuffle bit for bit."""

    def __init__(self, m: int):
        super().__init__()
        self.upsample_conv = _conv(m, 4 * m)

    def forward(self, x, act: nn.Module | None = None):
        return _pixel_shuffle(conv_act(self.upsample_conv, x, act), 2)


def _nhwc(flow: torch.Tensor) -> torch.Tensor:
    """The (n, h, w, 2) view of an (n, 2, h, w) flow, as the warps take
    it."""
    return flow.permute(0, 2, 3, 1)


class BasicVSRPP(LayoutFollowsDtype):
    """BasicVSR++ with mmagic's module names (module docstring). Build with
    ``BasicVSRPP.random`` or ``BasicVSRPP.from_state_dict``."""

    def __init__(self, cfg: BasicVSRPPConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.mid_channels
        self.spynet = SPyNet()
        self.feat_extract = ResidualBlocksWithInputConv(3, m, 5)
        self.deform_align = nn.ModuleDict({
            name: SecondOrderDeformableAlignment(m, cfg.deform_groups)
            for name in BRANCHES})
        self.backbone = nn.ModuleDict({
            name: ResidualBlocksWithInputConv((2 + j) * m, m, cfg.num_blocks)
            for j, name in enumerate(BRANCHES)})
        self.reconstruction = ResidualBlocksWithInputConv(5 * m, m, 5)
        self.upsample1 = PixelShufflePack(m)
        self.upsample2 = PixelShufflePack(m)
        self.conv_hr = _conv(m, m)
        self.conv_last = _conv(m, 3)
        self.lrelu = nn.LeakyReLU(0.1)

    @classmethod
    def random(cls, cfg: BasicVSRPPConfig, generator: torch.Generator,
               device: torch.device | str = "cpu") -> "BasicVSRPP":
        """Weights drawn from ``generator`` (a CPU generator) with torch's
        default bounds, then moved to ``device``; fp32."""
        with torch.device("meta"):
            net = cls(cfg)
        net = net.to_empty(device="cpu")
        init_torch_default(net, generator)
        return net.to(device).eval()

    @classmethod
    def from_state_dict(cls, cfg: BasicVSRPPConfig, state_dict,
                        device: torch.device | str = "cpu") -> "BasicVSRPP":
        """Weights from a state dict in mmagic's names or the port's
        (``port_state_dict``), copied to fp32 on ``device``; missing, extra
        or misshapen entries raise."""
        with torch.device("meta"):
            net = cls(cfg)
        sd = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32,
                                       copy=True)
              for k, v in cls.port_state_dict(state_dict).items()}
        net.load_state_dict(sd, strict=True, assign=True)
        return net.to(device).eval()

    @staticmethod
    def port_state_dict(state_dict) -> dict:
        """``state_dict`` in the port's names (``port_key``), without
        mmagic's SPyNet normalisation buffers."""
        return {port_key(k): v for k, v in state_dict.items()
                if k not in _BUFFERS}

    # ------------------------------------------------------------ the clip
    def compute_flows(self, x: torch.Tensor, chunk: int):
        """SPyNet over the frame pairs of x (t, n, c, h, w) fp32, ``chunk``
        pairs of the n clips at a time: (flows_backward, flows_forward),
        lists of t - 1 fp32 (n, 2, h, w)."""
        t, n, c, h, w = x.shape
        back, fwd = [], []
        for a in range(0, t - 1, chunk):
            b = min(a + chunk, t - 1)
            first = x[a:b].reshape(-1, c, h, w)
            second = x[a + 1:b + 1].reshape(-1, c, h, w)
            back += list(self.spynet(first, second).split(n))
            fwd += list(self.spynet(second, first).split(n))
        return back, fwd

    def align(self, name: str, prop: torch.Tensor, spatial: torch.Tensor,
              f1: torch.Tensor, second) -> torch.Tensor:
        """Branch ``name``'s second-order deformable alignment of the
        carried feature ``prop`` at a frame with spatial feature
        ``spatial``: ``f1`` (n, 2, h, w) is the flow from the frame to the
        one visited before; ``second`` is (p2, g), the branch's output two
        steps back and the flow from the frame visited before to it, or
        None at the branch's second step (p2, f2 and c2 zero). Returns the
        DCN's output, the new carried feature."""
        dt, fmt = prop.dtype, conv_format(prop.dtype)
        with tracing.span("infer.align"):
            c1 = warp_zero(prop, _nhwc(f1))
            if second is None:
                p2, f2 = torch.zeros_like(prop), torch.zeros_like(f1)
                c2 = torch.zeros_like(c1)
            else:
                p2, g = second
                f2 = f1 + warp_zero(g, _nhwc(f1))
                c2 = warp_zero(p2, _nhwc(f2))
            mod = self.deform_align[name]
            raw = run_fused(mod.conv_offset, cat_channels(
                [c1, spatial, c2, f1.to(dt), f2.to(dt)], fmt))
            with tracing.span("infer.dcn"):
                out = modulated_deform_conv(
                    cat_channels([prop, p2], fmt), raw, f1, f2, mod.weight,
                    mod.bias, self.cfg.max_residue_magnitude,
                    self.cfg.deform_groups)
            return out.contiguous(memory_format=fmt)

    def propagate(self, feats: dict, flows_back: list, flows_fwd: list,
                  j: int) -> list:
        """Branch ``BRANCHES[j]`` over every frame: its output at each
        frame, (n, m, h, w), in frame order."""
        name = BRANCHES[j]
        spatial = feats["spatial"]
        t = len(spatial)
        backward = name.startswith("backward")
        order = range(t - 1, -1, -1) if backward else range(t)
        fmt = conv_format(spatial[0].dtype)
        outs = [None] * t
        with tracing.span("infer.propagate", {"branch": j}):
            for s, i in enumerate(order):
                if s == 0:
                    prop = torch.zeros_like(spatial[i])
                else:
                    f1 = flows_back[i] if backward else flows_fwd[i - 1]
                    second = None
                    if s > 1:
                        second = ((outs[i + 2], flows_back[i + 1]) if backward
                                  else (outs[i - 2], flows_fwd[i - 2]))
                    prop = self.align(name, prop, spatial[i], f1, second)
                feat = cat_channels([spatial[i]]
                                    + [feats[k][i] for k in BRANCHES[:j]]
                                    + [prop], fmt)
                prop = prop + self.backbone[name](feat)
                outs[i] = prop
        return outs

    def reconstruct(self, lr: torch.Tensor, feats: list) -> torch.Tensor:
        """The HR frames of LR frames ``lr`` (N, 3, h, w) fp32 from their
        five features, each (N, m, h, w): uint8 (N, 3, 4h, 4w)."""
        fmt = conv_format(feats[0].dtype)
        with tracing.span("infer.reconstruct"):
            hr = self.reconstruction(cat_channels(feats, fmt))
            hr = self.upsample1(hr, self.lrelu)
            hr = self.upsample2(hr, self.lrelu)
            hr = conv_act(self.conv_last,
                          conv_act(self.conv_hr, hr, self.lrelu))
            base = F.interpolate(lr, scale_factor=4, mode="bilinear",
                                 align_corners=False)
            return quantize_uint8(hr.float() + base)

    def forward_clips(self, lr: torch.Tensor, chunk: int = 4) -> torch.Tensor:
        """(n, t, h, w, c) float in [0, 1] -> uint8 (n, t, 4h, 4w, c), on
        the device the net lives on, in its dtype, with no mode of its
        own (``infer_clip_batch`` enters inference mode)."""
        device = next(self.parameters()).device
        dt = next(self.parameters()).dtype
        fmt = conv_format(dt)
        n, t, h, w, c = lr.shape
        # frames first: a frame's n clips are one contiguous batch
        x = lr.to(device=device, dtype=torch.float32).permute(1, 0, 4, 2, 3)
        spatial = []
        for a in range(0, t, chunk):
            frames = x[a:a + chunk].reshape(-1, c, h, w)
            spatial += list(self.feat_extract(
                frames.to(dt, memory_format=fmt)).split(n))
        feats = {"spatial": spatial}
        with tracing.span("infer.flow"):
            flows_back, flows_fwd = self.compute_flows(x, chunk)
        for j, name in enumerate(BRANCHES):
            feats[name] = self.propagate(feats, flows_back, flows_fwd, j)
        del flows_back, flows_fwd
        out = torch.empty((n, t, 4 * h, 4 * w, c), dtype=torch.uint8,
                          device=device)
        keys = ("spatial",) + BRANCHES
        for a in range(0, t, chunk):
            b = min(a + chunk, t)
            hr = self.reconstruct(
                x[a:b].reshape(-1, c, h, w),
                [torch.cat(feats[k][a:b]) for k in keys])
            out[:, a:b] = hr.view(b - a, n, c, 4 * h, 4 * w).permute(
                1, 0, 3, 4, 2)
            for k in keys:  # the chunk's features are no longer needed
                feats[k][a:b] = [None] * (b - a)
        return out


# mmagic's SPyNet keeps its normalisation as buffers; the port's are
# constants
_BUFFERS = ("spynet.mean", "spynet.std")


def port_key(key: str) -> str:
    """The port's name of a parameter named as in mmagic's state dict:
    mmagic's residual blocks' ``conv1``/``conv2`` are SRNet's
    ``conv.0``/``conv.2``; every other name is the same."""
    return re.sub(r"\.conv([12])\.",
                  lambda mt: f".conv.{0 if mt.group(1) == '1' else 2}.", key)


def read_state_dict(path) -> dict:
    """A BasicVSR++ generator's state dict from a ``.pth``: a plain state
    dict, or mmagic's checkpoint (``state_dict`` with ``generator.``
    names), in mmagic's or the port's names (as stored)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    if any(k.startswith("generator.") for k in sd):
        sd = {k[len("generator."):]: v for k, v in sd.items()
              if k.startswith("generator.")}
    return sd


def infer_clip_batch(net, lr_seqs: torch.Tensor, cfg: BasicVSRPPConfig,
                     chunk: int = 4) -> torch.Tensor:
    """SR a batch of whole LR clips: (n, t, h, w, c) float -> uint8 (n, t,
    4h, 4w, c), on the device ``net`` lives on (``infer_sequence_batch``'s
    contract). ``net`` is a ``BasicVSRPP`` or a state dict in its names;
    it runs in ``cfg.compute_dtype`` (a cast copy where it is not). The
    frame loops take ``chunk`` frames of the n clips at a time."""
    lr_seqs = torch.as_tensor(lr_seqs)
    if not isinstance(net, nn.Module):
        net = BasicVSRPP.from_state_dict(cfg, net, device=lr_seqs.device)
    net = _compute_module(net, cfg.dtype)
    with torch.inference_mode():
        return net.forward_clips(lr_seqs, chunk)
