"""SRNet — reconstruction + upsampling trunk (port of
``tecogan_tpu/models/networks/srnet.py``, reference form
``srnet_apply(..., packed_tail=False)``).

conv_in + ReLU over cat(lr, space_to_depth(warped HR)), ``nb`` residual
blocks (conv-ReLU-conv + skip), one (2x) or two (4x) ConvTranspose2d(3, 2,
1, output_padding=1) + ReLU stages, conv_out, plus the upsampled LR frame
as global residual. The JAX package's TPU layout rewrites (packed tail,
folded conv_in, planes form) produce the same outputs and are not ported.

``forward_packed`` takes the warped HR frame already in space_to_depth
order (the packed16 recurrence's warp writes it so), and with
``row_masks``/``residual_mh`` runs the row-folded multi-stream layout, the
counterpart of ``srnet_apply_planes(row_masks=, residual_mh=)``.

In bf16 the activations from conv_in's input to conv_out's output are
channels_last, as a bf16 SRNet's convolution weights are
(``nn.LayoutFollowsDtype``); in fp32 everything is NCHW. The global
residual is NCHW in both, and the HR frame leaves contiguous NCHW.

Each convolution with its ReLU, its block's skip or the global residual is
one ``nn.conv_act``: in bf16 inference on a card the bias, the ReLU and the
residual are one kernel after cuDNN (``ops.conv_epilogue``), elsewhere the
modules' own ops.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import (LayoutFollowsDtype, cat_channels, conv_act,
                   network_layout, run_fused)
from ...ops.resize import (_device_matrix, apply_separable,
                           get_upsampling_fn, upsample_mode)
from ...ops.spatial import space_to_depth


def _conv(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1)


class ResidualBlock(nn.Module):
    def __init__(self, nf: int):
        super().__init__()
        self.conv = nn.Sequential(_conv(nf, nf), nn.ReLU(), _conv(nf, nf))

    def forward(self, x):
        conv0, relu, conv1 = self.conv
        return conv_act(conv1, conv_act(conv0, x, relu), residual=x)


class SRNet(LayoutFollowsDtype):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 10, scale: int = 4, degradation: str = "BD"):
        super().__init__()
        self.scale = scale
        self.upsample = get_upsampling_fn(scale, degradation)
        self.upsample_mode = upsample_mode(degradation)
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
        return self.forward_packed(lr_curr,
                                   space_to_depth(hr_warped, self.scale))

    def forward_packed(self, lr_curr: torch.Tensor, hr_packed: torch.Tensor,
                       row_masks: dict | None = None,
                       residual_mh: torch.Tensor | None = None
                       ) -> torch.Tensor:
        """lr_curr (n, c, h, w) + the warped previous HR frame in
        space_to_depth order (n, s*s*c, h, w) -> HR frame (n, out_nc, s*h,
        s*w).

        ``row_masks`` (row-folded streams, ``frnet._fold_masks``): 0/1 row
        masks ``lr`` (LR rows), ``up`` (2x rows) and ``planes`` (HR rows)
        that zero the guard rows between streams after conv_in + ReLU, after
        each residual conv and after each ConvTranspose + ReLU, so every
        conv sees zeros where a lone stream's zero padding would be.
        ``residual_mh`` replaces the global residual's vertical upsampling
        matrix (block-diagonal over the streams).
        """
        out = cat_channels([lr_curr, hr_packed], network_layout(lr_curr))
        if row_masks is None:
            out = run_fused(self.conv_up,
                            self.resblocks(run_fused(self.conv_in, out)))
            # the NCHW residual first: the sum takes its layout, so the HR
            # frame leaves contiguous NCHW with no copy of its own
            return conv_act(self.conv_out, out,
                            residual=self.upsample(lr_curr))
        m_lr = row_masks["lr"]
        out = self.conv_in(out) * m_lr
        for block in self.resblocks:
            conv0, relu, conv1 = block.conv
            res = relu(conv0(out)) * m_lr
            out = out + conv1(res) * m_lr
        stages = list(self.conv_up)
        for k in range(0, len(stages), 2):
            key = "planes" if k + 2 == len(stages) else "up"
            out = stages[k + 1](stages[k](out)) * row_masks[key]
        mw = _device_matrix(self.upsample_mode, lr_curr.shape[-1],
                            lr_curr.dtype, lr_curr.device, scale=self.scale)
        residual = apply_separable(lr_curr, residual_mh.to(lr_curr.dtype), mw)
        return residual + self.conv_out(out)
