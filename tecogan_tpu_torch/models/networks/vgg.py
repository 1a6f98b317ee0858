"""VGG19 features for the perceptual loss (port of
``tecogan_tpu/models/networks/vgg.py``).

torchvision's VGG19 ``features`` layout, written with ``nn.Conv2d`` (the
port does not depend on torchvision): parameter names
``features.{i}.weight|bias``, ImageNet normalisation in the input's dtype,
taps after the ReLUs at ``features`` indices {8, 17, 26, 35} = conv2_2,
conv3_4, conv4_4, conv5_4 by default (`codes/models/networks/
vgg_nets.py:6-38`), and the forward stops after the last tap. The net is
frozen. ImageNet weights are not in the repository; ``VGG19.random`` makes
a stand-in from a seed.
"""

from __future__ import annotations

import torch
from torch import nn

from ...nn import init_torch_default

__all__ = ["VGG19", "feature_index_map"]

# torchvision vgg19.features: conv widths and pool positions
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def feature_index_map() -> dict:
    """torchvision ``features`` index -> conv number (copied from
    ``tecogan_tpu/models/networks/vgg.py::feature_index_map``)."""
    mapping = {}
    seq_idx, conv_idx = 0, 0
    for v in _CFG:
        if v == "M":
            seq_idx += 1
        else:
            mapping[seq_idx] = conv_idx  # conv at seq_idx, relu at seq_idx+1
            seq_idx += 2
            conv_idx += 1
    return mapping


class VGG19(nn.Module):
    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in _CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, 1, 1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        # buffers, so they live on the net's device, outside the state dict
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN)[:, None,
                                                                  None],
                             persistent=False)
        self.register_buffer("std", torch.tensor(_IMAGENET_STD)[:, None,
                                                                None],
                             persistent=False)

    @classmethod
    def _empty(cls, device) -> "VGG19":
        """Unfilled weights on ``device``, the normalisation constants set."""
        with torch.device("meta"):
            net = cls()
        net = net.to_empty(device=device)
        net.mean.copy_(torch.tensor(_IMAGENET_MEAN)[:, None, None])
        net.std.copy_(torch.tensor(_IMAGENET_STD)[:, None, None])
        return net

    @classmethod
    def random(cls, generator: torch.Generator,
               device: torch.device | str = "cpu") -> "VGG19":
        """Weights drawn from ``generator`` (a CPU generator) with torch's
        default bounds, then moved to ``device``; fp32 and frozen."""
        net = cls._empty("cpu")
        init_torch_default(net, generator)
        return net.to(device).eval().requires_grad_(False)

    @classmethod
    def from_state_dict(cls, state_dict,
                        device: torch.device | str = "cpu") -> "VGG19":
        """Weights from a state dict in torchvision's ``features.*`` names
        (tensors or numpy arrays), copied; fp32 and frozen. Missing, extra
        or misshapen entries raise."""
        net = cls._empty(device)
        net.load_state_dict({k: torch.as_tensor(v)
                             for k, v in state_dict.items()}, strict=True)
        return net.eval().requires_grad_(False)

    def forward(self, x: torch.Tensor,
                feature_indexs=(8, 17, 26, 35)) -> list:
        """x (n, 3, h, w) in [0, 1] -> the feature maps at the
        ``features`` indices ``feature_indexs`` (after the layer at that
        index: a ReLU's index taps after it, a conv's before its ReLU)."""
        want = set(feature_indexs)
        if any(isinstance(self.features[i], nn.MaxPool2d) for i in want):
            raise ValueError("taps at pooling layers are unsupported")
        out = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        taps = []
        for i, layer in enumerate(self.features[:max(want) + 1]):
            out = layer(out)
            if i in want:
                taps.append(out)
        return taps
