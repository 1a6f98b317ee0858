"""Plain fp32 operations of the reference: the bilinear backward warp, the
resamplers, BD degradation, space-to-depth and the STNet input assembly.

Written from the published TecoGAN description (Chu et al., "Learning
temporal coherence via self-supervision for GAN-based video generation",
and its PyTorch reimplementation's ``codes/utils/net_utils.py`` and
``codes/models/networks/tecogan_nets.py``), with plain torch operations and
autograd only. Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the precision the reference's products take their operands in: None
# (fp32) or "fp8" (the control: every operand of a convolution, linear
# layer, resampler, blur and warp rounded to fp8, ``fp8``); or one value
# rounded to bf16 where ``flow_head`` or ``frame_out`` names it, for
# calibration's probes of where a bf16 program departs
ROUND = {"to": None}


def q(x: torch.Tensor) -> torch.Tensor:
    """x as the current precision holds a product's operand."""
    return fp8(x) if ROUND["to"] == "fp8" else x


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp of x (n, c, H, W) along flow (n, H, W, 2) = (dx, dy):
    out[i, j] = x bilinearly sampled at (clamp(i + dy, 0, H-1),
    clamp(j + dx, 0, W-1)), grid_sample's border padding with
    align_corners=True. Differentiable in x and in the flow (autograd of
    the gather and of the tap weights)."""
    n, c, h, w = x.shape
    x, f = q(x), q(flow.to(x.dtype))
    ii = torch.arange(h, dtype=x.dtype, device=x.device)[:, None]
    jj = torch.arange(w, dtype=x.dtype, device=x.device)[None, :]
    sy = torch.clamp(ii + f[..., 1], 0.0, h - 1.0)
    sx = torch.clamp(jj + f[..., 0], 0.0, w - 1.0)
    y0 = torch.floor(sy).detach()
    x0 = torch.floor(sx).detach()
    wy = (sy - y0)[:, None]
    wx = (sx - x0)[:, None]
    y0 = y0.long()
    x0 = x0.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    flat = x.reshape(n, c, h * w)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    return ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x1))
            + wy * ((1 - wx) * tap(y1, x0) + wx * tap(y1, x1)))


def _cubic_taps(s: float, a: float = -0.75) -> list:
    """Keys cubic-convolution weights of taps -1, 0, 1, 2 at offset s."""
    def k(d):
        d = abs(d)
        if d <= 1:
            return (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1
        if d < 2:
            return a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a
        return 0.0
    return [k(s + 1), k(s), k(1 - s), k(2 - s)]


def bicubic_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """The BD upsampler: separable 4-tap cubic (a = -0.75), output s*i + d
    from taps i-1 .. i+2 at offset d/s, replicate border. (n, c, h, w) ->
    (n, c, s*h, s*w)."""
    n, c, h, w = x.shape
    kern = torch.tensor([_cubic_taps(d / s) for d in range(s)],
                        dtype=x.dtype, device=x.device)  # (s, 4)
    kern = q(kern)
    t = F.pad(q(x).reshape(n * c, 1, h, w), (1, 2, 1, 2), mode="replicate")
    t = F.conv2d(t, kern.view(s, 1, 4, 1))  # (nc, s, h, w + 3)
    t = q(t.permute(0, 2, 1, 3).reshape(n * c, 1, s * h, w + 3))
    t = F.conv2d(t, kern.view(s, 1, 1, 4))  # (nc, s, s*h, w)
    return t.permute(0, 2, 3, 1).reshape(n, c, s * h, s * w)


def bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    """2x half-pixel bilinear upsampling (FNet's decoder)."""
    return F.interpolate(q(x), scale_factor=2, mode="bilinear",
                         align_corners=False)


def gaussian_kernel(sigma: float) -> torch.Tensor:
    """The normalised 1-D window of BD degradation, 1 + 2*int(3 sigma)
    taps."""
    k = 1 + 2 * int(3.0 * sigma)
    d = torch.arange(k, dtype=torch.float64) - (k - 1) / 2.0
    g = torch.exp(-d * d / (2.0 * sigma * sigma))
    return (g / g.sum()).float()


def bd_border(sigma: float) -> int:
    return int(3.0 * sigma)


def bd_degrade(gt: torch.Tensor, s: int, sigma: float):
    """Training-time BD: Gaussian blur + stride-s sampling as a valid
    convolution of (n, c, H, W) GT, and the GT cropped by the border the
    convolution consumed. Returns (gt, lr)."""
    n, c, hh, ww = gt.shape
    g = gaussian_kernel(sigma).to(gt.device, gt.dtype)
    k2 = (g[:, None] * g[None, :])[None, None].expand(c, 1, -1, -1)
    lr = F.conv2d(q(gt), q(k2.contiguous()), stride=s, groups=c)
    b = bd_border(sigma)
    lh, lw = lr.shape[-2:]
    return gt[..., b:b + s * lh, b:b + s * lw], lr


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(n, c, h, w) -> (n, s*s*c, h/s, w/s); channel (dy*s + dx)*c + ch."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // s, s, w // s, s)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, s * s * c, h // s, w // s)


def stnet_input(data, bi, hr_flow, crop_ratio: float, size: int):
    """The spatio-temporal discriminator's input from ping-pong sequences
    (n, t, c, H, W) of frames and of bicubic frames and the generator's HR
    flow (n, t-1, H, W, 2): per 3-frame clip the frames, the frames warped
    to the middle one (backward flow for the first, the mirrored half's
    backward flow for the last, the gradient stopped) with their borders
    cropped to ``crop_ratio`` and zero-padded back, and the bicubic frames,
    each packed channel-major ("rrrgggbbb"): (n_clip, 27, S, S)."""
    n, t_all, c, hh, ww = data.shape
    t = t_all // 3 * 3
    n_clip = n * (t // 3)
    with torch.no_grad():
        f_bw = hr_flow[:, 0:t:3]
        f_fw = hr_flow.flip(1)[:, 1:t:3]
    d3 = data[:, :t].reshape(n_clip, 3, c, hh, ww)
    first = warp(d3[:, 0], f_bw.reshape(n_clip, hh, ww, 2))
    last = warp(d3[:, 2], f_fw.reshape(n_clip, hh, ww, 2))
    warped = torch.stack([first, d3[:, 1], last], dim=1)

    def pack(x):
        return x.transpose(1, 2).reshape(n_clip, 3 * c, hh, ww)

    c_size = int(size * crop_ratio)
    pad = (size - c_size) // 2
    wp = pack(warped)
    if pad > 0:
        wp = F.pad(wp[..., pad:pad + c_size, pad:pad + c_size],
                   (pad, size - c_size - pad, pad, size - c_size - pad))
    cond = pack(bi[:, :t].reshape(n_clip, 3, c, hh, ww))
    return torch.cat([pack(d3), wp, cond], dim=1)


def charbonnier(x, y, eps: float = 1e-6):
    d = x - y
    return torch.sqrt(d * d + eps).mean()


def bce_logits(logits, real: bool):
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, 1.0 if real else 0.0))


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8 by clamp(round(255 x))."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


class _Bf16Tanh(torch.autograd.Function):
    """tanh with its output rounded to bf16 and its derivative 1 - y^2
    taken from the rounded output, as autograd of a bf16 tanh takes it."""

    @staticmethod
    def forward(ctx, x):
        y = torch.tanh(x).to(torch.bfloat16).float()
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (1.0 - y * y)


def _bf16_value(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 in the forward; its gradient passes through."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


def flow_head(pre: torch.Tensor) -> torch.Tensor:
    """FNet's flow, 24 * tanh(pre). Probes: ``ROUND["to"]`` "tanh" rounds
    the tanh's output to bf16 (``_Bf16Tanh``), "flow" the flow."""
    t = _Bf16Tanh.apply(pre) if ROUND["to"] == "tanh" else torch.tanh(pre)
    return _bf16_value(24.0 * t) if ROUND["to"] == "flow" else 24.0 * t


def frame_out(x: torch.Tensor) -> torch.Tensor:
    """SRNet's output frame; probe ``ROUND["to"]`` "frame" rounds it to
    bf16."""
    return _bf16_value(x) if ROUND["to"] == "frame" else x


def _scaled_round(x: torch.Tensor, fmt: torch.dtype, top: float):
    """x rounded to the float8 format ``fmt`` under one per-tensor scale
    (amax -> ``top``, the format's largest finite value), back in x's
    dtype. No host sync."""
    amax = torch.clamp(x.detach().abs().amax().float(), min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(fmt).float() / scale).to(x.dtype)


class _FakeQuant(torch.autograd.Function):
    """Forward: the operand rounded to e4m3; backward: the gradient rounded
    to e5m2, each under its own per-tensor scale (the usual fp8 training
    recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The fp8 control's rounding of a convolution or product operand."""
    return _FakeQuant.apply(x)


__all__ = ["warp", "bicubic_up", "bilinear_up2", "gaussian_kernel",
           "bd_border", "bd_degrade", "space_to_depth", "stnet_input",
           "charbonnier", "bce_logits", "quantize", "flow_head",
           "frame_out", "fp8", "q", "ROUND"]
