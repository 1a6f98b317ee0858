"""Weight bridges between the port's state dicts (reference names) and the
JAX package's pytrees: the generator, the discriminator trunk (STNet and
SNet) and VGG19.

- ``state_dict_from_jax`` (from ``utils/layout.py``, which the serving
  host reads without the models): the JAX package's generator pytree
  ``{'fnet': ..., 'srnet': ...}`` of numpy arrays (as ``init_frnet`` or a
  ``.npz`` checkpoint holds it) -> state dict. Layout rules, the inverse
  of ``tecogan_tpu/models/convert.py``:
  - conv HWIO (kh, kw, in, out) -> OIHW (out, in, kh, kw);
  - ConvTranspose: the JAX package stores the spatially flipped HWIO kernel
    of the equivalent convolution; torch wants (in, out, kh, kw)
    unflipped, so transpose and flip back.
- ``jax_from_state_dict`` (also from ``utils/layout.py``): the inverse,
  state dict -> JAX pytree of numpy
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
- ``load_state_dict`` (from ``utils/layout.py``): a reference ``.pth``
  state dict, which already uses the port's names.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.layout import (_arr, _jax_conv, _put_conv, _tensor,
                            jax_from_state_dict, load_state_dict,
                            state_dict_from_jax)
from .networks.vgg import feature_index_map

__all__ = ["state_dict_from_jax", "jax_from_state_dict",
           "d_state_dict_from_jax", "jax_from_d_state_dict",
           "vgg19_state_dict_from_jax", "vgg19_jax_from_state_dict",
           "load_state_dict"]

_D_CHANNELS = 256  # the trunk's last block (discriminators._BLOCKS)


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
