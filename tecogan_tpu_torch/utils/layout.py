"""The generator's weights in the two layouts: the port's state dict
(reference names, OIHW) and the JAX package's pytree (HWIO). Numpy and
torch only, so that a serving host reads a bundle's or a checkpoint's
weights without the port's models (``models/convert.py`` re-exports these
beside the discriminator's and VGG19's bridges).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "jax_from_state_dict", "load_state_dict"]


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


def state_dict_from_jax(params, nb: int | None = None,
                        scale: int | None = None) -> dict:
    """JAX generator pytree (numpy leaves) -> port state dict. ``nb`` and
    ``scale`` default to what the pytree holds (its ``res{i}_0`` and
    ``up{i}`` entries)."""
    srnet = params["srnet"]
    if nb is None:
        nb = sum(k.startswith("res") and k.endswith("_0") for k in srnet)
    if scale is None:
        scale = 4 if "up1" in srnet else 2
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


def jax_from_state_dict(sd, nb: int | None = None,
                        scale: int | None = None) -> dict:
    """Port state dict (tensors or arrays) -> JAX generator pytree
    ``{'fnet': ..., 'srnet': ...}`` of fp32 numpy arrays. ``nb`` and
    ``scale`` default to what the state dict holds (its residual blocks
    and transposed convolutions)."""
    if nb is None:
        nb = sum(k.startswith("srnet.resblocks.") and k.endswith(
            ".conv.0.weight") for k in sd)
    if scale is None:
        scale = 4 if "srnet.conv_up.2.weight" in sd else 2
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


def load_state_dict(path) -> dict:
    """A reference ``.pth`` generator state dict (CPU tensors)."""
    return torch.load(path, map_location="cpu", weights_only=True)
