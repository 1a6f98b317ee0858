"""SRNet — reconstruction + upsampling trunk (port of
``tecogan_tpu/models/networks/srnet.py``, reference form
``srnet_apply(..., packed_tail=False)``).

conv_in + ReLU over cat(lr, space_to_depth(warped HR)), ``nb`` residual
blocks (conv-ReLU-conv + skip), one (2x) or two (4x) ConvTranspose2d(3, 2,
1, output_padding=1) + ReLU stages, conv_out, plus the upsampled LR frame
as global residual. The JAX package's TPU layout rewrites (packed tail,
folded conv_in, planes form) produce the same outputs and are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.resize import get_upsampling_fn
from ...ops.spatial import space_to_depth


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class ResidualBlock(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.conv = nn.Sequential(_conv(nf, nf), nn.ReLU(), _conv(nf, nf))

    def forward(self, x):
        return x + self.conv(x)


class SRNet(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 10, scale: int = 4, degradation: str = "BD"):
        super().__init__()
        self.scale = scale
        self.upsample = get_upsampling_fn(scale, degradation)
        self.conv_in = nn.Sequential(
            _conv((scale * scale + 1) * in_nc, nf), nn.ReLU())
        self.resblocks = nn.Sequential(*[ResidualBlock(nf) for _ in range(nb)])
        ups = []
        for _ in range(2 if scale == 4 else 1):
            ups += [nn.ConvTranspose2d(nf, nf, 3, 2, 1, output_padding=1),
                    nn.ReLU()]
        self.conv_up = nn.Sequential(*ups)
        self.conv_out = _conv(nf, out_nc)

    def forward(self, lr_curr: torch.Tensor,
                hr_warped: torch.Tensor) -> torch.Tensor:
        """lr_curr (n, c, h, w) + warped previous HR (n, c, s*h, s*w) ->
        HR frame (n, out_nc, s*h, s*w)."""
        out = torch.cat([lr_curr, space_to_depth(hr_warped, self.scale)], 1)
        out = self.conv_up(self.resblocks(self.conv_in(out)))
        return self.conv_out(out) + self.upsample(lr_curr)
