"""Discriminators: spatio-temporal (STNet) and spatial (SNet), port of
``tecogan_tpu/models/networks/discriminators.py``.

STNet consumes 3-frame clips as a 27-channel stack of three triplets:
the original frames, the frames warped along a gradient-stopped flow merge
and the bicubic-conditioned frames, each packed "rrrgggbbb" (channel =
colour * 3 + frame, `tecogan_nets.py:440-463`). SNet consumes single
frames, conditioned on the bicubic frame when ``use_cond``. Both share one
trunk (``DTrunk``): a 3x3 conv + LeakyReLU(0.2), four 4x4/stride-2 convs
without bias, each with BatchNorm and LeakyReLU, and a dense logit over the
NCHW-flattened /16 feature map, under the reference's parameter names
(``conv_in.0``, ``discriminator_block.block{1..4}.{0,1}``, ``dense``), so a
reference ``.pth`` loads by name. A train step runs the trunk through
``torch.func.functional_call`` with its parameters cast for mixed
precision; the BatchNorm running stats are the module's own buffers,
updated in place by each training-mode forward.

Frames here are NCHW: sequences are (n, t, c, H, W) and flows
(n, H, W, 2), as the warps take them; the D input is (clips or frames,
channels, S, S).
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ...nn import F64ForwardConv2d, batch_norm, init_torch_default
from ...ops.warp_vjp import backward_warp_diff

__all__ = ["STNetConfig", "SNetConfig", "BatchNorm2d", "DTrunk",
           "build_flow_merge", "build_stnet_input", "build_d_input"]

_BLOCKS = [(64, 64), (64, 64), (64, 128), (128, 256)]


@dataclasses.dataclass(frozen=True)
class STNetConfig:
    in_nc: int = 3
    spatial_size: int = 128
    tempo_range: int = 3

    @property
    def in_channels(self) -> int:
        return self.in_nc * self.tempo_range * 3


@dataclasses.dataclass(frozen=True)
class SNetConfig:
    in_nc: int = 3
    spatial_size: int = 128
    use_cond: bool = True

    @property
    def in_channels(self) -> int:
        return self.in_nc * (2 if self.use_cond else 1)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose statistics are fp32 whatever the input's dtype
    (``nn.batch_norm``); the output is in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            self.num_batches_tracked.add_(1)
        return batch_norm(x, self.running_mean, self.running_var,
                          self.weight, self.bias, self.training,
                          self.momentum, self.eps)


class DTrunk(nn.Module):
    """The discriminator trunk shared by STNet and SNet."""

    def __init__(self, cfg: STNetConfig | SNetConfig):
        super().__init__()
        self.conv_in = nn.Sequential(
            F64ForwardConv2d(cfg.in_channels, 64, 3, 1, 1), nn.LeakyReLU(0.2))
        self.discriminator_block = nn.Sequential(collections.OrderedDict(
            (f"block{i + 1}", nn.Sequential(
                F64ForwardConv2d(cin, cout, 4, 2, 1, bias=False),
                BatchNorm2d(cout), nn.LeakyReLU(0.2)))
            for i, (cin, cout) in enumerate(_BLOCKS)))
        feat = cfg.spatial_size // 16
        self.dense = nn.Linear(_BLOCKS[-1][1] * feat * feat, 1)

    @classmethod
    def random(cls, cfg, generator: torch.Generator,
               device: torch.device | str = "cpu") -> "DTrunk":
        """Weights drawn from ``generator`` (a CPU generator) with torch's
        default bounds, then moved to ``device``; fp32, in training mode."""
        with torch.device("meta"):
            net = cls(cfg)
        net = net.to_empty(device="cpu")
        init_torch_default(net, generator)
        return net.to(device).train()

    @classmethod
    def from_state_dict(cls, cfg, state_dict,
                        device: torch.device | str = "cpu") -> "DTrunk":
        """Weights and BatchNorm stats from a state dict in the reference's
        names (tensors or numpy arrays), copied (floats as fp32); in
        training mode. Missing, extra or misshapen entries raise."""
        with torch.device("meta"):
            net = cls(cfg)
        sd = {}
        for k, v in state_dict.items():
            v = torch.as_tensor(v)
            sd[k] = v.to(device=device, copy=True,
                         dtype=torch.float32 if v.is_floating_point()
                         else v.dtype)
        net.load_state_dict(sd, strict=True, assign=True)
        return net.train()

    def forward(self, x: torch.Tensor):
        """x (n, in_channels, S, S) -> (logits (n, 1), the four blocks'
        outputs)."""
        out = self.conv_in(x)
        feats = []
        for block in self.discriminator_block:
            out = block(out)
            feats.append(out)
        return self.dense(out.flatten(1)), feats

    def bn_parameter_names(self) -> set:
        """The names of the BatchNorm scales and biases, which mixed
        precision leaves in fp32."""
        return {f"{name}.{p}" for name, m in self.named_modules()
                if isinstance(m, nn.BatchNorm2d) for p in ("weight", "bias")}


# --------------------------------------------------------------------------
# STNet input assembly
# --------------------------------------------------------------------------

def _pack_triplet(x: torch.Tensor) -> torch.Tensor:
    """(n_clip, 3, c, H, W) -> (n_clip, 3*c, H, W), channel = ch*3 + frame
    ("rrrgggbbb", `tecogan_nets.py:440-444`)."""
    n, t3, c, h, w = x.shape
    return x.transpose(1, 2).reshape(n, c * t3, h, w)


def build_flow_merge(hr_flow: torch.Tensor, lr_data: torch.Tensor,
                     net_g, params_g: dict, use_pp: bool) -> torch.Tensor:
    """Backward/idle/forward flow per 3-frame clip, gradient-stopped:
    (n_clip*3, H, W, 2).

    ``hr_flow`` (n, t-1, H, W, 2) is the unroll's HR flow. With ping-pong
    data the forward flow of a clip is a backward flow of the mirrored half,
    sliced from it (`tecogan_nets.py:409-411`); otherwise an extra FNet pass
    over (frame 1, frame 2) of each clip of ``lr_data`` (n, t, h, w, c),
    with the generator ``net_g``'s FNet under ``params_g``, upsampled by
    ``FRNet.hr_flow`` (`tecogan_nets.py:413-425`).
    """
    n, tm1, hr_h, hr_w, _ = hr_flow.shape
    t = (tm1 + 1) // 3 * 3
    n_clip = n * (t // 3)
    with torch.no_grad():
        flow_bw = hr_flow[:, 0:t:3]
        flow_idle = torch.zeros_like(flow_bw)
        if use_pp:
            flow_fw = hr_flow.flip(1)[:, 1:t:3]
        else:
            _, _, lh, lw, c = lr_data.shape
            x = lr_data.permute(0, 1, 4, 2, 3)
            lr_curr = x[:, 1:t:3].reshape(n_clip, c, lh, lw)
            lr_next = x[:, 2:t:3].reshape(n_clip, c, lh, lw)
            fnet = {k[len("fnet."):]: v.detach() for k, v in params_g.items()
                    if k.startswith("fnet.")}
            lr_flow_fw = functional_call(net_g.fnet, fnet, (lr_curr, lr_next))
            flow_fw = net_g.hr_flow(lr_flow_fw, lh, lw).permute(
                0, 2, 3, 1).reshape(n, t // 3, hr_h, hr_w, 2)
        merge = torch.stack([flow_bw, flow_idle, flow_fw], dim=2)
        return merge.reshape(n_clip * 3, hr_h, hr_w, 2)


def build_stnet_input(data: torch.Tensor, bi_data: torch.Tensor,
                      flow_merge: torch.Tensor, crop_border_ratio: float,
                      cfg: STNetConfig) -> torch.Tensor:
    """The 27-channel D input (n_clip, 27, S, S) from (n, t, c, H, W)
    sequences: the original triplets, the warped ones and the bicubic
    ones."""
    n, t_all, c, hh, ww = data.shape
    t = t_all // 3 * 3
    n_clip = n * (t // 3)

    cond = _pack_triplet(bi_data[:, :t].reshape(n_clip, 3, c, hh, ww))
    d3 = data[:, :t].reshape(n_clip, 3, c, hh, ww)
    orig = _pack_triplet(d3)

    # the idle (middle) slot's flow is zero and warping along it is the
    # identity: only the two end slots are warped, in one call
    fm3 = flow_merge.reshape(n_clip, 3, hh, ww, 2)
    ends = d3[:, ::2].reshape(n_clip * 2, c, hh, ww)
    f_ends = fm3[:, ::2].reshape(n_clip * 2, hh, ww, 2)
    w_ends = backward_warp_diff(ends, f_ends).reshape(n_clip, 2, c, hh, ww)
    warped = _pack_triplet(torch.stack([w_ends[:, 0], d3[:, 1],
                                        w_ends[:, 1]], dim=1))

    # crop the warped borders, then zero-pad back (`tecogan_nets.py:457-460`)
    s_size = cfg.spatial_size
    c_size = int(s_size * crop_border_ratio)
    n_pad = (s_size - c_size) // 2
    if n_pad > 0:
        warped = warped[..., n_pad:n_pad + c_size, n_pad:n_pad + c_size]
        rest = s_size - c_size - n_pad
        warped = F.pad(warped, (n_pad, rest, n_pad, rest))

    return torch.cat([orig, warped, cond], dim=1)


def build_d_input(data: torch.Tensor, ctx: dict, cfg) -> torch.Tensor:
    """The discriminator input for an (n, t, c, H, W) sequence, without
    the trunk, so a train step assembles each input once. ``ctx``:
    ``bi_data`` (the bicubic sequence), and for STNet ``flow_merge``
    (``build_flow_merge``) and ``crop_border_ratio``."""
    if isinstance(cfg, STNetConfig):
        return build_stnet_input(data, ctx["bi_data"], ctx["flow_merge"],
                                 ctx["crop_border_ratio"], cfg)
    n, t, c, hh, ww = data.shape
    x = data.reshape(n * t, c, hh, ww)
    if cfg.use_cond:
        x = torch.cat([ctx["bi_data"].reshape(n * t, c, hh, ww), x], dim=1)
    return x
