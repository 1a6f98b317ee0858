"""Weight bridges between the port's state dicts (reference names) and the
JAX package's pytrees: the generator, the discriminator trunk (STNet and
SNet) and VGG19.

- ``state_dict_from_jax``: the JAX package's generator pytree
  ``{'fnet': ..., 'srnet': ...}`` of numpy arrays (as ``init_frnet`` or a
  ``.npz`` checkpoint holds it) -> state dict. Layout rules, the inverse
  of ``tecogan_tpu/models/convert.py``:
  - conv HWIO (kh, kw, in, out) -> OIHW (out, in, kh, kw);
  - ConvTranspose: the JAX package stores the spatially flipped HWIO kernel
    of the equivalent convolution; torch wants (in, out, kh, kw)
    unflipped, so transpose and flip back.
- ``jax_from_state_dict``: the inverse, state dict -> JAX pytree of numpy
  arrays, the counterpart of ``tecogan_tpu/models/convert.py::
  convert_frnet``; ``G_iter{n}.npz`` checkpoints are written through it in
  the JAX package's layout.
- ``d_state_dict_from_jax`` / ``jax_from_d_state_dict``: the
  discriminator trunk both ways, the inverse of and the counterpart of
  ``tecogan_tpu/models/convert.py::convert_stnet`` (``_convert_trunk``).
  The dense weight is (din, 1) over the NHWC-flattened (h, w, c) feature
  map in the JAX package and (1, c*h*w) over the NCHW-flattened one here
  (``_dense_from_nchw``); BatchNorm's scale/bias/mean/var are
  weight/bias/running_mean/running_var, and ``num_batches_tracked``, which
  the JAX package does not keep, starts at 0. ``D_iter{n}.npz`` is written
  through ``jax_from_d_state_dict``.
- ``vgg19_state_dict_from_jax`` / ``vgg19_jax_from_state_dict``: VGG19's
  ``conv{i}`` pytree and torchvision's ``features.{j}`` names, by
  ``vgg.feature_index_map``; the latter takes a torchvision VGG19 state
  dict as it is (the inverse of ``convert_vgg19``).
- ``load_state_dict``: a reference ``.pth`` state dict, which already uses
  the port's names.
"""

from __future__ import annotations

import numpy as np
import torch

from .networks.vgg import feature_index_map

__all__ = ["state_dict_from_jax", "jax_from_state_dict",
           "d_state_dict_from_jax", "jax_from_d_state_dict",
           "vgg19_state_dict_from_jax", "vgg19_jax_from_state_dict",
           "load_state_dict"]

_D_CHANNELS = 256  # the trunk's last block (discriminators._BLOCKS)


def _tensor(a) -> torch.Tensor:
    # a copy: the leaves may be read-only views of another framework's buffer
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _arr(sd, name) -> np.ndarray:
    v = sd[name]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.array(v, dtype=np.float32)


def _jax_conv(sd, name, bias: bool = True) -> dict:
    p = {"w": np.ascontiguousarray(_arr(sd, f"{name}.weight")
                                   .transpose(2, 3, 1, 0))}
    if bias:
        p["b"] = _arr(sd, f"{name}.bias")
    return p


def _put_conv(sd, name, p):
    sd[f"{name}.weight"] = _tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    if "b" in p:
        sd[f"{name}.bias"] = _tensor(p["b"])


def state_dict_from_jax(params, nb: int = 10, scale: int = 4) -> dict:
    """JAX generator pytree (numpy leaves) -> port state dict."""
    sd = {}

    def put_conv(name, p):
        _put_conv(sd, name, p)

    def put_convt(name, p):
        w = np.asarray(p["w"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"{name}.weight"] = _tensor(w)
        sd[f"{name}.bias"] = _tensor(p["b"])

    f = params["fnet"]
    for li in range(3):
        put_conv(f"fnet.encoder{li + 1}.0", f[f"enc{li}_0"])
        put_conv(f"fnet.encoder{li + 1}.2", f[f"enc{li}_1"])
        put_conv(f"fnet.decoder{li + 1}.0", f[f"dec{li}_0"])
        put_conv(f"fnet.decoder{li + 1}.2", f[f"dec{li}_1"])
    put_conv("fnet.flow.0", f["flow_0"])
    put_conv("fnet.flow.2", f["flow_1"])
    s = params["srnet"]
    put_conv("srnet.conv_in.0", s["conv_in"])
    for bi in range(nb):
        put_conv(f"srnet.resblocks.{bi}.conv.0", s[f"res{bi}_0"])
        put_conv(f"srnet.resblocks.{bi}.conv.2", s[f"res{bi}_1"])
    for ui in range(2 if scale == 4 else 1):
        put_convt(f"srnet.conv_up.{2 * ui}", s[f"up{ui}"])
    put_conv("srnet.conv_out", s["conv_out"])
    return sd


def jax_from_state_dict(sd, nb: int = 10, scale: int = 4) -> dict:
    """Port state dict (tensors or arrays) -> JAX generator pytree
    ``{'fnet': ..., 'srnet': ...}`` of fp32 numpy arrays."""
    def arr(name):
        return _arr(sd, name)

    def conv(name):
        return _jax_conv(sd, name)

    def convt(name):
        w = arr(f"{name}.weight")[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        return {"w": np.ascontiguousarray(w),
                "b": np.array(arr(f"{name}.bias"))}

    fnet = {}
    for li in range(3):
        fnet[f"enc{li}_0"] = conv(f"fnet.encoder{li + 1}.0")
        fnet[f"enc{li}_1"] = conv(f"fnet.encoder{li + 1}.2")
        fnet[f"dec{li}_0"] = conv(f"fnet.decoder{li + 1}.0")
        fnet[f"dec{li}_1"] = conv(f"fnet.decoder{li + 1}.2")
    fnet["flow_0"] = conv("fnet.flow.0")
    fnet["flow_1"] = conv("fnet.flow.2")
    srnet = {"conv_in": conv("srnet.conv_in.0")}
    for bi in range(nb):
        srnet[f"res{bi}_0"] = conv(f"srnet.resblocks.{bi}.conv.0")
        srnet[f"res{bi}_1"] = conv(f"srnet.resblocks.{bi}.conv.2")
    for ui in range(2 if scale == 4 else 1):
        srnet[f"up{ui}"] = convt(f"srnet.conv_up.{2 * ui}")
    srnet["conv_out"] = conv("srnet.conv_out")
    return {"fnet": fnet, "srnet": srnet}


def d_state_dict_from_jax(params, spatial_size: int = 128) -> dict:
    """JAX discriminator pytree (STNet or SNet, numpy leaves) -> port
    state dict."""
    sd = {}
    _put_conv(sd, "conv_in.0", params["conv_in"])
    for bi in range(4):
        name = f"discriminator_block.block{bi + 1}"
        blk = params[f"block{bi}"]
        _put_conv(sd, f"{name}.0", blk["conv"])
        bn = blk["bn"]
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{name}.1.{ours}"] = _tensor(bn[theirs])
        sd[f"{name}.1.num_batches_tracked"] = torch.zeros((),
                                                          dtype=torch.int64)
    f = spatial_size // 16
    w = np.asarray(params["dense"]["w"])  # (f*f*c, dout), (h, w, c) order
    dout = w.shape[1]
    sd["dense.weight"] = _tensor(w.T.reshape(dout, f, f, _D_CHANNELS)
                                 .transpose(0, 3, 1, 2).reshape(dout, -1))
    sd["dense.bias"] = _tensor(params["dense"]["b"])
    return sd


def jax_from_d_state_dict(sd, spatial_size: int = 128) -> dict:
    """Port (or reference) discriminator state dict -> JAX pytree of fp32
    numpy arrays."""
    p = {"conv_in": _jax_conv(sd, "conv_in.0")}
    for bi in range(4):
        name = f"discriminator_block.block{bi + 1}"
        p[f"block{bi}"] = {
            "conv": _jax_conv(sd, f"{name}.0", bias=False),
            "bn": {theirs: _arr(sd, f"{name}.1.{ours}")
                   for ours, theirs in (("weight", "scale"),
                                        ("bias", "bias"),
                                        ("running_mean", "mean"),
                                        ("running_var", "var"))}}
    f = spatial_size // 16
    w = _arr(sd, "dense.weight")  # (dout, c*f*f), (c, h, w) order
    dout = w.shape[0]
    w = w.reshape(dout, _D_CHANNELS, f, f).transpose(0, 2, 3, 1)
    p["dense"] = {"w": np.ascontiguousarray(w.reshape(dout, -1).T),
                  "b": _arr(sd, "dense.bias")}
    return p


def vgg19_state_dict_from_jax(params) -> dict:
    """JAX VGG19 pytree ``{'conv{i}': ...}`` -> port state dict."""
    sd = {}
    for seq_idx, ci in feature_index_map().items():
        _put_conv(sd, f"features.{seq_idx}", params[f"conv{ci}"])
    return sd


def vgg19_jax_from_state_dict(sd) -> dict:
    """Port or torchvision VGG19 state dict -> JAX pytree of fp32 numpy
    arrays (entries outside ``features`` are ignored)."""
    return {f"conv{ci}": _jax_conv(sd, f"features.{seq_idx}")
            for seq_idx, ci in feature_index_map().items()}


def load_state_dict(path) -> dict:
    """A reference ``.pth`` generator state dict (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)
