"""FNet — coarse-to-fine optical-flow estimator (port of
``tecogan_tpu/models/networks/fnet.py``).

Three encoder levels (two 3x3 convs + LeakyReLU(0.2), then 2x2 max-pool
with floor), three decoder levels (two 3x3 convs + LeakyReLU, then a 2x
half-pixel bilinear upsample) and a flow head whose output is
``tanh(.) * 24``. Module names follow the reference's state dict
(``encoder1.0``, ``decoder1.2``, ``flow.0``, ...).

In bf16 the activations between the input's cat and the flow head are
channels_last, as a bf16 FNet's convolution weights are
(``nn.LayoutFollowsDtype``), and the decoders' upsample runs on the NHWC
memory; in fp32 everything is NCHW. Either way the flow leaves contiguous
NCHW. Each convolution and its LeakyReLU are one ``nn.conv_act`` (one
kernel after cuDNN in bf16 inference on a card).
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import (LayoutFollowsDtype, cat_channels, network_layout,
                   run_fused)
from ...ops.resize import upsample_bilinear, upsample_nhwc

_ENC = [32, 64, 128]
_DEC = [256, 128, 64]
_MAX_VELOCITY = 24.0


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class FNet(LayoutFollowsDtype):
    def __init__(self, in_nc: int = 3):
        super().__init__()
        cin = 2 * in_nc
        for li, c in enumerate(_ENC):
            setattr(self, f"encoder{li + 1}", nn.Sequential(
                _conv(cin, c), nn.LeakyReLU(0.2), _conv(c, c),
                nn.LeakyReLU(0.2), nn.MaxPool2d(2, 2)))
            cin = c
        for li, c in enumerate(_DEC):
            setattr(self, f"decoder{li + 1}", nn.Sequential(
                _conv(cin, c), nn.LeakyReLU(0.2), _conv(c, c),
                nn.LeakyReLU(0.2)))
            cin = c
        self.flow = nn.Sequential(_conv(cin, 32), nn.LeakyReLU(0.2),
                                  _conv(32, 2))

    def forward(self, x_cur: torch.Tensor, x_prev: torch.Tensor):
        """Flow from x_cur to x_prev: (n, c, h, w) x2 -> (n, 2, h', w') with
        h' = (h // 8) * 8 (the max-pools floor odd sizes)."""
        fmt = network_layout(x_cur)
        out = cat_channels([x_cur, x_prev], fmt)
        for enc in (self.encoder1, self.encoder2, self.encoder3):
            out = run_fused(enc, out)
        for dec in (self.decoder1, self.decoder2, self.decoder3):
            out = run_fused(dec, out)
            if fmt == torch.channels_last:
                out = upsample_nhwc(out, "bilinear_half_pixel", 2)
            else:
                out = upsample_bilinear(out, 2)
        flow = run_fused(self.flow, out).contiguous()
        return torch.tanh(flow) * _MAX_VELOCITY
