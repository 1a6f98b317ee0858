"""Plain fp32 BasicVSR++ of the reference (Chan, Zhou, Xu, Loy, "BasicVSR++:
Improving Video Super-Resolution with Enhanced Propagation and Alignment",
CVPR 2022, arXiv:2104.13371), written from mmagic's
``mmagic/models/editors/basicvsr_plusplus_net/basicvsr_plusplus_net.py``
with its module and parameter names, so one state dict made by the
benchmark loads here and into the program. Plain torch operations only; it
imports nothing of the program under test. Each convolution and the DCN's
product round their operands as ``ROUND`` says (``ops.q``): fp32 by
default, fp8 for the control. Run it with TF32 off (``train.no_tf32``).

Departures from mmagic's forward pass, none of which changes an output
compared here:

- inference only, one clip at a time (``infer`` loops over the clips);
- no ``check_if_mirror_extended``: the benchmark's clips are not
  mirror-extended (mmagic would then take the forward flows as the
  backward ones reversed, the same values), and no ``cpu_cache`` (where
  the features are kept changes nothing);
- SPyNet's mean and std are constants, not state-dict buffers;
- the DCN (mmcv's ``modulated_deform_conv2d``) is written out: per
  deformable group and tap, the bilinear sample of every channel of the
  group with zero padding (mmcv's ``dmcn_im2col_bilinear``), times the
  mask, as columns (channel, tap), then one matrix product with the
  weight;
- each HR frame is quantised to uint8, ``clamp(round(255 x))``, as it is
  made.

The weights are whatever state dict is loaded: mmagic zero-initialises
conv_offset's last convolution and loads SPyNet's released weights, while
the benchmark draws every weight from its seed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .nets import Conv2d
from .ops import q, quantize

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")


def flow_warp(x, flow, padding_mode="zeros"):
    """mmagic's ``flow_warp``: x (n, c, h, w) sampled by ``grid_sample``
    (bilinear, align_corners=True) at the pixel grid plus flow (n, h, w,
    2) in (x, y) order."""
    n, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device),
                            torch.arange(w, device=x.device), indexing="ij")
    grid = torch.stack((gx, gy), 2).float() + q(flow)
    gxn = 2.0 * grid[..., 0] / max(w - 1, 1) - 1.0
    gyn = 2.0 * grid[..., 1] / max(h - 1, 1) - 1.0
    return F.grid_sample(q(x), torch.stack((gxn, gyn), 3), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True)


def modulated_deform_conv(x, offset, mask, weight, bias, groups):
    """mmcv's modulated deformable convolution at 3x3, stride 1, padding 1,
    dilation 1: offset (n, 18 groups, h, w), channel 2 (9 g + k) the row
    and 2 (9 g + k) + 1 the column displacement of tap k = 3 ky + kx of
    group g; mask (n, 9 groups, h, w). Every sample point is gathered
    explicitly."""
    n, c, h, w = x.shape
    cg = c // groups
    dev = x.device
    off = offset.view(n, groups, 9, 2, h, w)
    ky = torch.arange(9, device=dev) // 3
    kx = torch.arange(9, device=dev) % 3
    py = (torch.arange(h, device=dev).view(1, h, 1) - 1
          + ky.view(9, 1, 1)).float() + off[:, :, :, 0]
    px = (torch.arange(w, device=dev).view(1, 1, w) - 1
          + kx.view(9, 1, 1)).float() + off[:, :, :, 1]
    inside = (py > -1) & (px > -1) & (py < h) & (px < w)
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    hy, hx = 1 - ly, 1 - lx
    src = q(x).view(n, groups, cg, h * w)

    def corner(yy, xx):
        ok = inside & (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
        vals = src.gather(3, idx.view(n, groups, 1, 9 * h * w).expand(
            n, groups, cg, 9 * h * w)).view(n, groups, cg, 9, h, w)
        return vals * ok[:, :, None]

    val = ((hy * hx)[:, :, None] * corner(y0, x0)
           + (hy * lx)[:, :, None] * corner(y0, x0 + 1)
           + (ly * hx)[:, :, None] * corner(y0 + 1, x0)
           + (ly * lx)[:, :, None] * corner(y0 + 1, x0 + 1))
    cols = (val * mask.view(n, groups, 1, 9, h, w)).reshape(n, c * 9, h * w)
    out = q(weight).reshape(weight.shape[0], c * 9) @ q(cols)
    return (out + bias.view(1, -1, 1)).view(n, -1, h, w)


class ConvModule(nn.Module):
    def __init__(self, cin, cout, act=True):
        super().__init__()
        self.conv = Conv2d(cin, cout, 7, 1, 3)
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        return F.relu(x) if self.act else x


class SPyNetBasicModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.Sequential(
            ConvModule(8, 32), ConvModule(32, 64), ConvModule(64, 32),
            ConvModule(32, 16), ConvModule(16, 2, act=False))

    def forward(self, x):
        return self.basic_module(x)


class SPyNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(
            [SPyNetBasicModule() for _ in range(6)])

    def compute_flow(self, ref, supp):
        n, _, h, w = ref.shape
        mean = torch.tensor([0.485, 0.456, 0.406],
                            device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225],
                           device=ref.device).view(1, 3, 1, 1)
        ref, supp = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(5):
            ref.append(F.avg_pool2d(ref[-1], 2, 2, count_include_pad=False))
            supp.append(F.avg_pool2d(supp[-1], 2, 2,
                                     count_include_pad=False))
        ref, supp = ref[::-1], supp[::-1]
        flow = ref[0].new_zeros(n, 2, h // 32, w // 32)
        for level in range(len(ref)):
            if level == 0:
                flow_up = flow
            else:
                flow_up = F.interpolate(q(flow), scale_factor=2,
                                        mode="bilinear",
                                        align_corners=True) * 2.0
            flow = flow_up + self.basic_module[level](torch.cat([
                ref[level],
                flow_warp(supp[level], flow_up.permute(0, 2, 3, 1),
                          padding_mode="border"),
                flow_up], 1))
        return flow

    def forward(self, ref, supp):
        h, w = ref.shape[2:4]
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        ref = F.interpolate(q(ref), size=(h_up, w_up), mode="bilinear",
                            align_corners=False)
        supp = F.interpolate(q(supp), size=(h_up, w_up), mode="bilinear",
                             align_corners=False)
        flow = F.interpolate(q(self.compute_flow(ref, supp)), size=(h, w),
                             mode="bilinear", align_corners=False)
        flow[:, 0, :, :] *= float(w) / float(w_up)
        flow[:, 1, :, :] *= float(h) / float(h_up)
        return flow


class ResidualBlockNoBN(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.conv1 = Conv2d(m, m, 3, 1, 1)
        self.conv2 = Conv2d(m, m, 3, 1, 1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class ResidualBlocksWithInputConv(nn.Module):
    def __init__(self, cin, m, blocks):
        super().__init__()
        self.main = nn.Sequential(
            Conv2d(cin, m, 3, 1, 1), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(m) for _ in range(blocks)]))

    def forward(self, x):
        return self.main(x)


class SecondOrderDeformableAlignment(nn.Conv2d):
    """The DCN's weight and bias (mmcv's ModulatedDeformConv2d holds them
    as a convolution's) and ``conv_offset``."""

    def __init__(self, m, groups, max_residue_magnitude):
        super().__init__(2 * m, m, 3, 1, 1)
        self.groups_ = groups
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset = nn.Sequential(
            Conv2d(3 * m + 4, m, 3, 1, 1), nn.LeakyReLU(0.1),
            Conv2d(m, m, 3, 1, 1), nn.LeakyReLU(0.1),
            Conv2d(m, m, 3, 1, 1), nn.LeakyReLU(0.1),
            Conv2d(m, 27 * groups, 3, 1, 1))

    def forward(self, x, extra_feat, flow_1, flow_2):
        extra_feat = torch.cat([extra_feat, flow_1, flow_2], dim=1)
        out = self.conv_offset(extra_feat)
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = self.max_residue_magnitude * torch.tanh(
            torch.cat((o1, o2), dim=1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
        offset_1 = offset_1 + flow_1.flip(1).repeat(
            1, offset_1.size(1) // 2, 1, 1)
        offset_2 = offset_2 + flow_2.flip(1).repeat(
            1, offset_2.size(1) // 2, 1, 1)
        offset = torch.cat([offset_1, offset_2], dim=1)
        mask = torch.sigmoid(mask)
        return modulated_deform_conv(x, offset, mask, self.weight, self.bias,
                                     self.groups_)


class PixelShufflePack(nn.Module):
    def __init__(self, m, scale=2):
        super().__init__()
        self.scale = scale
        self.upsample_conv = Conv2d(m, m * scale * scale, 3, 1, 1)

    def forward(self, x):
        return F.pixel_shuffle(self.upsample_conv(x), self.scale)


class BasicVSRPlusPlus(nn.Module):
    def __init__(self, mid_channels=64, num_blocks=7,
                 max_residue_magnitude=10, deform_groups=16):
        super().__init__()
        m = self.mid_channels = mid_channels
        self.spynet = SPyNet()
        self.feat_extract = ResidualBlocksWithInputConv(3, m, 5)
        self.deform_align = nn.ModuleDict()
        self.backbone = nn.ModuleDict()
        for i, name in enumerate(BRANCHES):
            self.deform_align[name] = SecondOrderDeformableAlignment(
                m, deform_groups, max_residue_magnitude)
            self.backbone[name] = ResidualBlocksWithInputConv(
                (2 + i) * m, m, num_blocks)
        self.reconstruction = ResidualBlocksWithInputConv(5 * m, m, 5)
        self.upsample1 = PixelShufflePack(m)
        self.upsample2 = PixelShufflePack(m)
        self.conv_hr = Conv2d(m, m, 3, 1, 1)
        self.conv_last = Conv2d(m, 3, 3, 1, 1)
        self.lrelu = nn.LeakyReLU(0.1)

    def compute_flow(self, lqs):
        n, t, c, h, w = lqs.size()
        lqs_1 = lqs[:, :-1].reshape(-1, c, h, w)
        lqs_2 = lqs[:, 1:].reshape(-1, c, h, w)
        flows_backward = self.spynet(lqs_1, lqs_2).view(n, t - 1, 2, h, w)
        flows_forward = self.spynet(lqs_2, lqs_1).view(n, t - 1, 2, h, w)
        return flows_forward, flows_backward

    def propagate(self, feats, flows, module_name):
        n, t, _, h, w = flows.size()
        frame_idx = range(0, t + 1)
        flow_idx = range(-1, t)
        mapping_idx = list(range(0, len(feats["spatial"])))
        mapping_idx += mapping_idx[::-1]
        if "backward" in module_name:
            frame_idx = frame_idx[::-1]
            flow_idx = frame_idx
        feat_prop = flows.new_zeros(n, self.mid_channels, h, w)
        for i, idx in enumerate(frame_idx):
            feat_current = feats["spatial"][mapping_idx[idx]]
            if i > 0:
                flow_n1 = flows[:, flow_idx[i], :, :, :]
                cond_n1 = flow_warp(feat_prop, flow_n1.permute(0, 2, 3, 1))
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = feats[module_name][-2]
                    flow_n2 = flows[:, flow_idx[i - 1], :, :, :]
                    flow_n2 = flow_n1 + flow_warp(
                        flow_n2, flow_n1.permute(0, 2, 3, 1))
                    cond_n2 = flow_warp(feat_n2, flow_n2.permute(0, 2, 3, 1))
                cond = torch.cat([cond_n1, feat_current, cond_n2], dim=1)
                feat_prop = torch.cat([feat_prop, feat_n2], dim=1)
                feat_prop = self.deform_align[module_name](
                    feat_prop, cond, flow_n1, flow_n2)
            feat = ([feat_current] + [
                feats[k][idx] for k in feats
                if k not in ["spatial", module_name]] + [feat_prop])
            feat = torch.cat(feat, dim=1)
            feat_prop = feat_prop + self.backbone[module_name](feat)
            feats[module_name].append(feat_prop)
        if "backward" in module_name:
            feats[module_name] = feats[module_name][::-1]
        return feats

    def upsample(self, lqs, feats, out):
        """The HR frames of the clip lqs (1, t, c, h, w), each quantised
        into ``out`` (t, 4h, 4w, c) uint8 as it is made."""
        for i in range(lqs.size(1)):
            hr = [feats[k].pop(0) for k in feats if k != "spatial"]
            hr.insert(0, feats["spatial"][i])
            hr = torch.cat(hr, dim=1)
            hr = self.reconstruction(hr)
            hr = self.lrelu(self.upsample1(hr))
            hr = self.lrelu(self.upsample2(hr))
            hr = self.lrelu(self.conv_hr(hr))
            hr = self.conv_last(hr)
            hr = hr + F.interpolate(q(lqs[:, i]), scale_factor=4,
                                    mode="bilinear", align_corners=False)
            out[i] = quantize(hr[0]).permute(1, 2, 0)

    def forward_clip(self, lqs, out):
        n, t, c, h, w = lqs.size()
        feats = {}
        feats_ = self.feat_extract(lqs.view(-1, c, h, w))
        h, w = feats_.shape[2:]
        feats_ = feats_.view(n, t, -1, h, w)
        feats["spatial"] = [feats_[:, i] for i in range(0, t)]
        flows_forward, flows_backward = self.compute_flow(lqs)
        for iter_ in [1, 2]:
            for direction in ["backward", "forward"]:
                module = f"{direction}_{iter_}"
                feats[module] = []
                flows = (flows_backward if direction == "backward"
                         else flows_forward)
                feats = self.propagate(feats, flows, module)
        self.upsample(lqs, feats, out)

    @torch.no_grad()
    def infer(self, lr):
        """(n, t, h, w, c) LR in [0, 1] -> uint8 (n, t, 4h, 4w, c), one
        clip at a time."""
        n, t, h, w, c = lr.shape
        out = torch.empty(n, t, 4 * h, 4 * w, c, dtype=torch.uint8,
                          device=lr.device)
        for b in range(n):
            self.forward_clip(lr[b:b + 1].permute(0, 1, 4, 2, 3).float(),
                              out[b])
        return out
