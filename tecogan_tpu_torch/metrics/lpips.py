"""LPIPS (net-lin) perceptual distance with the AlexNet, VGG16 and
SqueezeNet1.1 trunks (port of ``tecogan_tpu/metrics/lpips.py``).

Architecture per LPIPS v0.1 (`codes/metrics/LPIPS/models/networks_basic.py:27-101`):
shift/scale input normalisation, a frozen feature trunk tapped after its
ReLU stages (5 taps; 7 for SqueezeNet), channel-unit-normalised feature
differences, squared, 1x1 learned linear heads, spatial average (or, with
``spatial``, each head's map upsampled to the input size), summed over the
taps.

The trunks are torchvision's ``features`` written with ``nn.Conv2d`` and
max-pooling (SqueezeNet's pools in ceil mode), under torchvision's
state-dict names, so a torchvision checkpoint loads as it is; torchvision
itself is not imported. The heads are the v0.1 checkpoints'
``lin{i}.model.1.weight``. Either piece may also be an ``.npz`` in the
JAX package's layout. The weights are not in the repository:
``find_lpips_weights`` searches for them and the metric stacks leave LPIPS
out with a warning where they are missing.

LPIPS runs in fp32 with TF32 off (``nn.inference_numerics``) on the device
it is given: ``cuda`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import inference_numerics
from ..ops.resize import _device_matrix, apply_separable

__all__ = ["LPIPS", "find_lpips_weights", "AlexNetFeatures",
           "VGG16Features", "SqueezeNetFeatures"]

# input normalisation (networks_basic.py ScalingLayer constants)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# per-net tap channel counts (networks_basic.py:41-47)
_NET_CHANS = {
    "alex": [64, 192, 384, 256, 256],
    "vgg": [64, 128, 256, 512, 512],
    "squeeze": [64, 128, 256, 384, 384, 512, 512],
}
# (backbone checkpoint stem, lin-head checkpoint stem) per net
_NET_FILES = {
    "alex": ("alexnet", "alex"),
    "vgg": ("vgg16", "vgg"),
    "squeeze": ("squeezenet1_1", "squeeze"),
}


def _canon_net(net: str) -> str:
    net = {"vgg16": "vgg"}.get(net, net)  # reference accepts both spellings
    if net not in _NET_CHANS:
        raise ValueError(f"unknown LPIPS backbone {net!r}; expected one of "
                         f"{sorted(_NET_CHANS)} (or 'vgg16')")
    return net


class _Trunk(nn.Module):
    """torchvision's ``features`` Sequential, run up to its last tap; the
    outputs of the layers at ``taps`` are the LPIPS features."""

    taps: tuple = ()

    def forward(self, x):
        out = []
        for i, layer in enumerate(self.features[:self.taps[-1] + 1]):
            x = layer(x)
            if i in self.taps:
                out.append(x)
        return out

    def jax_tree_names(self):
        """(JAX pytree path, features index) of each convolution."""
        return [(f"conv{ci}", i) for ci, i in enumerate(
            i for i, m in enumerate(self.features)
            if isinstance(m, nn.Conv2d))]


class AlexNetFeatures(_Trunk):
    """torchvision AlexNet's features; taps after each of its 5 ReLUs."""

    taps = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(), nn.MaxPool2d(3, 2))


class VGG16Features(_Trunk):
    """torchvision VGG16's features: 13 3x3 convs in blocks of (2, 2, 3, 3,
    3) with 2x2 pools between; taps relu{1_2,2_2,3_3,4_3,5_3}."""

    taps = (3, 8, 15, 22, 29)

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for bi, (n_convs, cout) in enumerate(zip((2, 2, 3, 3, 3),
                                                 (64, 128, 256, 512, 512))):
            if bi:
                layers.append(nn.MaxPool2d(2, 2))
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, cout, 3, 1, 1), nn.ReLU()]
                cin = cout
        layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)


class Fire(nn.Module):
    """SqueezeNet's Fire: 1x1 squeeze -> ReLU -> [1x1, 3x3 expand] each ->
    ReLU, concatenated over channels (torchvision's names)."""

    def __init__(self, cin, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2d(cin, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, e1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, e3, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.expand1x1(s)),
                          F.relu(self.expand3x3(s))], 1)


class SqueezeNetFeatures(_Trunk):
    """torchvision SqueezeNet1.1's features (3x3/2 pools in ceil mode); taps
    after the first ReLU, the fire pairs 4 and 7, then fires 9-12."""

    taps = (1, 4, 7, 9, 10, 11, 12)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 3, 2), nn.ReLU(),
            nn.MaxPool2d(3, 2, ceil_mode=True),
            Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
            nn.MaxPool2d(3, 2, ceil_mode=True),
            Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
            nn.MaxPool2d(3, 2, ceil_mode=True),
            Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
            Fire(384, 64, 256, 256), Fire(512, 64, 256, 256))

    def jax_tree_names(self):
        names = [("conv0", 0)]
        for i, m in enumerate(self.features):
            if isinstance(m, Fire):
                names += [(f"fire{i}/{part}", f"{i}.{part}")
                          for part in ("squeeze", "expand1x1", "expand3x3")]
        return names


_TRUNKS = {"alex": AlexNetFeatures, "vgg": VGG16Features,
           "squeeze": SqueezeNetFeatures}


def find_lpips_weights(search_dirs=("pretrained_models/lpips",),
                       net: str = "alex"):
    """Locate (backbone .npz|.pth, lin heads .npz|.pth) in ``search_dirs``
    for the given backbone; None per missing piece."""
    net = _canon_net(net)
    bb_stem, lin_stem = _NET_FILES[net]
    bb_names = [f"{bb_stem}.npz", f"{bb_stem}.pth"]
    if net == "alex":
        bb_names.append("alexnet-owt.pth")
    backbone = lin = None
    for d in search_dirs:
        for name in bb_names:
            p = osp.join(d, name)
            if backbone is None and osp.exists(p):
                backbone = p
        for name in (f"{lin_stem}.npz", f"{lin_stem}.pth"):
            p = osp.join(d, name)
            if lin is None and osp.exists(p):
                lin = p
    return backbone, lin


def _load_trunk(trunk: _Trunk, path: str) -> None:
    """A torchvision state dict (``.pth``; its ``features`` entries) or the
    JAX package's converted pytree (``.npz``, HWIO) into ``trunk``."""
    if path.endswith(".npz"):
        from ..utils.ckpt import load_pytree

        tree = load_pytree(path)
        sd = {}
        for name, idx in trunk.jax_tree_names():
            node = tree
            for part in name.split("/"):
                node = node[part]
            w = np.asarray(node["w"], np.float32).transpose(3, 2, 0, 1)
            sd[f"features.{idx}.weight"] = torch.from_numpy(
                np.ascontiguousarray(w))
            sd[f"features.{idx}.bias"] = torch.from_numpy(
                np.asarray(node["b"], np.float32))
    else:
        sd = {k: v for k, v in torch.load(path, map_location="cpu",
                                          weights_only=True).items()
              if k.startswith("features.")}
    trunk.load_state_dict(sd, strict=True)


def _load_heads(path: str, n_taps: int) -> list:
    """The v0.1 heads (``lin{i}.model.1.weight``, (1, C, 1, 1)) from a
    ``.pth``, or the JAX package's (1, 1, C, 1) HWIO kernels from an
    ``.npz``, as (1, C, 1, 1) fp32 tensors."""
    if path.endswith(".npz"):
        from ..utils.ckpt import load_pytree

        return [torch.from_numpy(np.ascontiguousarray(
            np.asarray(h, np.float32).transpose(3, 2, 0, 1)))
            for h in load_pytree(path)]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return [sd[f"lin{i}.model.1.weight"].float() for i in range(n_taps)]


class LPIPS:
    """Callable LPIPS distance. Raises FileNotFoundError at construction if
    weights are missing, and RuntimeError for ``cuda`` without a card.

    ``net``: 'alex' (shipped configs), 'vgg'/'vgg16' or 'squeeze'.
    ``spatial``: return per-pixel maps, each head's map bilinearly
    upsampled (half-pixel, torch align_corners=False) to the input size
    and summed over the taps (`networks_basic.py:75-78`), in place of
    scalars. ``device``: where the trunk runs, the card unless the caller
    passes the CPU."""

    def __init__(self, net: str = "alex", backbone_path=None, lin_path=None,
                 spatial: bool = False,
                 device: torch.device | str = "cuda"):
        self.net = net = _canon_net(net)
        self.spatial = bool(spatial)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LPIPS: no CUDA device; pass device='cpu' to "
                               "run on the CPU explicitly")
        auto_bb, auto_lin = find_lpips_weights(net=net)
        backbone_path = backbone_path or auto_bb
        lin_path = lin_path or auto_lin
        if backbone_path is None or lin_path is None:
            bb_stem, lin_stem = _NET_FILES[net]
            raise FileNotFoundError(
                f"LPIPS weights unavailable for net='{net}': need an "
                f"ImageNet backbone checkpoint ('{bb_stem}.pth' torchvision "
                f"format or converted .npz) and the LPIPS v0.1 "
                f"'{lin_stem}.pth' linear heads under "
                f"pretrained_models/lpips/")
        trunk = _TRUNKS[net]()
        _load_trunk(trunk, backbone_path)
        self.trunk = trunk.to(self.device).eval()
        heads = _load_heads(lin_path, len(_NET_CHANS[net]))
        got_chans = [int(h.shape[1]) for h in heads]
        if got_chans != _NET_CHANS[net]:
            raise ValueError(
                f"lin heads at {lin_path} have channels {got_chans}, but "
                f"net='{net}' taps are {_NET_CHANS[net]} -- wrong checkpoint "
                f"for this backbone?")
        self.heads = [h.to(self.device) for h in heads]
        self.shift = torch.tensor(_SHIFT, device=self.device).view(1, 3, 1, 1)
        self.scale = torch.tensor(_SCALE, device=self.device).view(1, 3, 1, 1)

    def distance(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (n, 3, h, w) in [-1, 1] on the device -> (n,) distances,
        or (n, h, w) per-pixel maps when ``spatial``."""
        in_h, in_w = x.shape[-2:]
        fx = self.trunk((x - self.shift) / self.scale)
        fy = self.trunk((y - self.shift) / self.scale)
        total = 0.0
        for tx, ty, head in zip(fx, fy, self.heads):
            nx = tx * torch.rsqrt(torch.sum(tx * tx, 1, keepdim=True) + 1e-10)
            ny = ty * torch.rsqrt(torch.sum(ty * ty, 1, keepdim=True) + 1e-10)
            val = F.conv2d((nx - ny) ** 2, head)
            if self.spatial:
                mh = _device_matrix("bilinear_fractional", val.shape[-2],
                                    val.dtype, val.device, out_size=in_h)
                mw = _device_matrix("bilinear_fractional", val.shape[-1],
                                    val.dtype, val.device, out_size=in_w)
                total = total + apply_separable(val, mh, mw)[:, 0]
            else:
                total = total + torch.mean(val, dim=(1, 2, 3))
        return total

    def __call__(self, img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
        """uint8 RGB (h, w, c) or (n, h, w, c) images -> (n,) distances,
        or (n, h, w) per-pixel maps when ``spatial``."""
        a = np.asarray(img_a, np.float32)
        b = np.asarray(img_b, np.float32)
        if a.ndim == 3:
            a, b = a[None], b[None]

        def tensor(v):
            v = v * (2.0 / 255.0) - 1.0
            return torch.from_numpy(np.ascontiguousarray(
                v.transpose(0, 3, 1, 2))).to(self.device)

        with torch.inference_mode(), inference_numerics("float32"):
            return self.distance(tensor(a), tensor(b)).cpu().numpy()
