"""Weight bridges between the port's state dict (reference names) and the
JAX package's generator pytree.

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
- ``load_state_dict``: a reference ``.pth`` state dict, which already uses
  the port's names.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "jax_from_state_dict", "load_state_dict"]


def _tensor(a) -> torch.Tensor:
    # a copy: the leaves may be read-only views of another framework's buffer
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def state_dict_from_jax(params, nb: int = 10, scale: int = 4) -> dict:
    """JAX generator pytree (numpy leaves) -> port state dict."""
    sd = {}

    def put_conv(name, p):
        sd[f"{name}.weight"] = _tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _tensor(p["b"])

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
        v = sd[name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, dtype=np.float32)

    def conv(name):
        return {"w": np.ascontiguousarray(
                    arr(f"{name}.weight").transpose(2, 3, 1, 0)),
                "b": np.array(arr(f"{name}.bias"))}

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


def load_state_dict(path) -> dict:
    """A reference ``.pth`` generator state dict (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)
