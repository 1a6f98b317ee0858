"""Model profiling: analytic per-module GFLOPs and parameters, and
PyTorch's own count of one step (port of
``tecogan_tpu/metrics/model_summary.py``).

``profile_frnet`` is copied as it is: convolution FLOPs are counted
analytically (2*K_h*K_w*C_in*C_out*H_out*W_out per conv; transposed convs
at the INPUT spatial size, the reference's accounting at
`model_summary.py:47-48`), plus parameter totals. ``flop_count`` takes the
place of the JAX package's XLA cost analysis: ``FlopCounterMode``'s count
of one call. It counts the transposed convolutions at their input size,
as the analytic rule does, and adds the matrix products of the resampling
(FNet's 2x bilinear decoder upsampling, the flow's and the LR residual's
4x upsampling), which the analytic count leaves out; it counts no
elementwise work (the warp, the activations, the adds).

Note on the published "142 GFLOPs" (benchmark.png): at 3x134x320 this tool
-- like the reference's own -- reports ~94.4 G; the published figure counts
the transposed convs at their OUTPUT size (TecoGAN-TF lineage), which adds
~48 G. Both accountings describe the same network.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["profile_frnet", "count_params", "flop_count"]


def _conv_flops(k, cin, cout, h_out, w_out):
    return 2.0 * k * k * cin * cout * h_out * w_out


def count_params(module: torch.nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


def flop_count(fn, *args) -> int:
    """FLOPs ``FlopCounterMode`` counts for one call of ``fn(*args)``."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def profile_frnet(cfg, lr_size):
    """Analytic FLOPs/params per module for one generator step.

    lr_size: (c, h, w) like the reference CLI. Returns
    ({'FNet': gflops, 'SRNet': gflops}, {'FNet': params, 'SRNet': params}).
    """
    c, h, w = lr_size
    s, nf, nb = cfg.scale, cfg.nf, cfg.nb

    # ---- FNet: encoder (2 convs per level, /2 after), decoder (2 convs,
    # x2 after), flow head
    enc = [(2 * c, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128)]
    dec = [(128, 256), (256, 256), (256, 128), (128, 128), (128, 64),
           (64, 64)]
    flow = [(64, 32), (32, 2)]
    fl = 0.0
    params_f = 0
    hh, ww = h, w
    for i, (ci, co) in enumerate(enc):
        fl += _conv_flops(3, ci, co, hh, ww)
        params_f += 9 * ci * co + co
        if i % 2 == 1:
            hh, ww = hh // 2, ww // 2
    for i, (ci, co) in enumerate(dec):
        fl += _conv_flops(3, ci, co, hh, ww)
        params_f += 9 * ci * co + co
        if i % 2 == 1:
            hh, ww = hh * 2, ww * 2
    for ci, co in flow:
        fl += _conv_flops(3, ci, co, hh, ww)
        params_f += 9 * ci * co + co

    # ---- SRNet: conv_in + nb residual blocks + upsampling convT + conv_out
    sl = _conv_flops(3, (s * s + 1) * c, nf, h, w)
    params_s = 9 * (s * s + 1) * c * nf + nf
    sl += nb * 2 * _conv_flops(3, nf, nf, h, w)
    params_s += nb * 2 * (9 * nf * nf + nf)
    hh, ww = h, w
    for _ in range(2 if s == 4 else 1):
        # ConvTranspose FLOPs accounted at the input size (reference rule)
        sl += _conv_flops(3, nf, nf, hh, ww)
        params_s += 9 * nf * nf + nf
        hh, ww = hh * 2, ww * 2
    sl += _conv_flops(3, nf, c, hh, ww)
    params_s += 9 * nf * c + c

    gflops = {"FNet": fl / 1e9, "SRNet": sl / 1e9}
    params = {"FNet": params_f, "SRNet": params_s}
    return gflops, params
