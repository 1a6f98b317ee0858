"""Plain fp32 networks of the reference: FNet, SRNet, the frame-recurrent
generator (training unroll and streaming inference), the discriminator
trunk and VGG19 to conv5_4.

Parameter names are those of the published PyTorch state dicts
(``codes/models/networks/tecogan_nets.py``, torchvision's ``vgg19``), so one
state dict made by the benchmark loads into the program and into these.
Each convolution and linear layer rounds its operands as ``ROUND`` says
(``ops.q``): fp32 by default, fp8 for the control.
"""

from __future__ import annotations

import collections

import torch
import torch.nn.functional as F
from torch import nn

from .ops import (ROUND, bicubic_up, bilinear_up2, flow_head, frame_out, q,
                  quantize, space_to_depth, warp)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(q(x), q(self.weight), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x, output_size=None):
        return F.conv_transpose2d(q(x), q(self.weight), self.bias,
                                  self.stride, self.padding,
                                  self.output_padding)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(q(x), q(self.weight), self.bias)


def _c(cin, cout, k=3, s=1, p=1, bias=True):
    return Conv2d(cin, cout, k, s, p, bias=bias)


class FNet(nn.Module):
    """Flow estimator: three encoder levels (2 convs + LeakyReLU, 2x2
    max-pool), three decoder levels (2 convs + LeakyReLU, 2x bilinear up),
    a flow head, 24 * tanh."""

    def __init__(self, in_nc=3):
        super().__init__()
        enc = [(2 * in_nc, 32), (32, 64), (64, 128)]
        dec = [(128, 256), (256, 128), (128, 64)]
        for i, (ci, co) in enumerate(enc):
            setattr(self, f"encoder{i + 1}", nn.Sequential(
                _c(ci, co), nn.LeakyReLU(0.2), _c(co, co), nn.LeakyReLU(0.2),
                nn.MaxPool2d(2, 2)))
        for i, (ci, co) in enumerate(dec):
            setattr(self, f"decoder{i + 1}", nn.Sequential(
                _c(ci, co), nn.LeakyReLU(0.2), _c(co, co), nn.LeakyReLU(0.2)))
        self.flow = nn.Sequential(_c(64, 32), nn.LeakyReLU(0.2), _c(32, 2))

    def forward(self, cur, prev):
        h = torch.cat([cur, prev], 1)
        h = self.encoder3(self.encoder2(self.encoder1(h)))
        for dec in (self.decoder1, self.decoder2, self.decoder3):
            h = bilinear_up2(dec(h))
        return flow_head(self.flow(h))


class _Res(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.conv = nn.Sequential(_c(nf, nf), nn.ReLU(), _c(nf, nf))

    def forward(self, x):
        return x + self.conv(x)


class SRNet(nn.Module):
    """conv_in + ReLU over cat(LR, space_to_depth(warped HR)), nb residual
    blocks, two 2x transposed convs + ReLU (4x), conv_out, plus the
    bicubic-upsampled LR frame."""

    def __init__(self, in_nc=3, out_nc=3, nf=64, nb=10, scale=4):
        super().__init__()
        self.scale = scale
        self.conv_in = nn.Sequential(_c((scale * scale + 1) * in_nc, nf),
                                     nn.ReLU())
        self.resblocks = nn.Sequential(*[_Res(nf) for _ in range(nb)])
        ups = []
        for _ in range({4: 2, 2: 1}[scale]):
            ups += [ConvTranspose2d(nf, nf, 3, 2, 1, output_padding=1),
                    nn.ReLU()]
        self.conv_up = nn.Sequential(*ups)
        self.conv_out = _c(nf, out_nc)

    def forward(self, lr, hr_warped):
        h = self.conv_in(torch.cat(
            [lr, space_to_depth(hr_warped, self.scale)], 1))
        h = self.conv_out(self.conv_up(self.resblocks(h)))
        return frame_out(h + bicubic_up(lr, self.scale))


class FRNet(nn.Module):
    def __init__(self, nf=64, nb=10, scale=4, in_nc=3, out_nc=3):
        super().__init__()
        self.scale = scale
        self.fnet = FNet(in_nc)
        self.srnet = SRNet(in_nc, out_nc, nf, nb, scale)

    def hr_flow(self, lr_flow, h, w):
        """(n, 2, h8, w8) -> (n, 2, s*h, s*w): reflect-padded to the LR
        size, upsampled, velocities scaled."""
        ph, pw = h - lr_flow.shape[-2], w - lr_flow.shape[-1]
        if ph or pw:
            lr_flow = F.pad(lr_flow, (0, pw, 0, ph), mode="reflect")
        return self.scale * bicubic_up(lr_flow, self.scale)

    def forward_sequence(self, lr):
        """Training unroll of (n, t, c, h, w) LR: returns HR (n, t, c, sh,
        sw), the HR flow (n, t-1, sh, sw, 2), the LR flow (n*(t-1), 2, h,
        w) and the (prev, cur) LR frames it was estimated from."""
        n, t, c, h, w = lr.shape
        s = self.scale
        prev = lr[:, :-1].reshape(n * (t - 1), c, h, w)
        cur = lr[:, 1:].reshape(n * (t - 1), c, h, w)
        lr_flow = self.fnet(cur, prev)
        hr_flow = self.hr_flow(lr_flow, h, w).reshape(
            n, t - 1, 2, s * h, s * w).permute(0, 1, 3, 4, 2)
        hr = self.srnet(lr[:, 0], torch.zeros(n, c, s * h, s * w,
                                              device=lr.device))
        outs = [hr]
        for i in range(1, t):
            hr = self.srnet(lr[:, i], warp(hr, hr_flow[:, i - 1]))
            outs.append(hr)
        return torch.stack(outs, 1), hr_flow, lr_flow, prev, cur

    @torch.no_grad()
    def infer(self, lr, flow_block: int = 16):
        """Streaming inference of (n, t, h, w, c) LR in [0, 1]: each frame's
        flow from (frame, previous frame), zeros before the first; the
        previous HR output warped along it; uint8 (n, t, s*h, s*w, c)."""
        n, t, h, w, c = lr.shape
        x = lr.permute(0, 1, 4, 2, 3).float()
        prevs = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
        hr_prev = torch.zeros(n, c, self.scale * h, self.scale * w,
                              device=lr.device)
        out = torch.empty(n, t, self.scale * h, self.scale * w, c,
                          dtype=torch.uint8, device=lr.device)
        for k in range(0, t, flow_block):
            cur = x[:, k:k + flow_block]
            m = cur.shape[1]
            flows = self.hr_flow(self.fnet(
                cur.reshape(n * m, c, h, w),
                prevs[:, k:k + m].reshape(n * m, c, h, w)), h, w)
            flows = flows.reshape(n, m, 2, self.scale * h, self.scale * w)
            for i in range(m):
                hr_prev = self.srnet(cur[:, i], warp(
                    hr_prev, flows[:, i].permute(0, 2, 3, 1)))
                out[:, k + i] = quantize(hr_prev).permute(0, 2, 3, 1)
        return out


class DTrunk(nn.Module):
    """The discriminator: 3x3 conv + LeakyReLU, four 4x4 stride-2 convs
    without bias, each with BatchNorm (batch statistics) and LeakyReLU, a
    dense logit over the flattened /16 map. Returns (logits, the four
    blocks' outputs)."""

    def __init__(self, cin=27, size=128):
        super().__init__()
        self.conv_in = nn.Sequential(_c(cin, 64), nn.LeakyReLU(0.2))
        chans = [(64, 64), (64, 64), (64, 128), (128, 256)]
        self.discriminator_block = nn.Sequential(collections.OrderedDict(
            (f"block{i + 1}", nn.Sequential(
                _c(ci, co, 4, 2, 1, bias=False), nn.BatchNorm2d(co),
                nn.LeakyReLU(0.2)))
            for i, (ci, co) in enumerate(chans)))
        self.dense = Linear(256 * (size // 16) ** 2, 1)

    def forward(self, x):
        h = self.conv_in(x)
        feats = []
        for blk in self.discriminator_block:
            h = blk(h)
            feats.append(h)
        return self.dense(h.flatten(1)), feats


VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class VGG19(nn.Module):
    """torchvision's VGG19 ``features`` on ImageNet-normalised input,
    tapped after the ReLUs at the given indices, stopping at the last."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [_c(cin, v), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)

    def forward(self, x, taps=(8, 17, 26, 35)):
        mean = torch.tensor([0.485, 0.456, 0.406], device=x.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=x.device)
        h = (x - mean[:, None, None]) / std[:, None, None]
        out = []
        for i, layer in enumerate(self.features[:max(taps) + 1]):
            h = layer(h)
            if i in taps:
                out.append(h)
        return out


def load(net: nn.Module, state_dict: dict, device) -> nn.Module:
    """``net`` with fp32 copies of ``state_dict``'s tensors (strict)."""
    net.load_state_dict({k: v.detach().to(device=device, dtype=torch.float32
                                          if v.is_floating_point()
                                          else v.dtype, copy=True)
                         for k, v in state_dict.items()}, strict=True)
    return net.to(device)
