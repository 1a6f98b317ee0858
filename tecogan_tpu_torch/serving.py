"""Export and load of the streaming SR program for serving (port of
``tecogan_tpu/serving.py``).

``export_stream`` traces ``frnet.stream_frames`` (the recurrence of
``infer_sequence_batch``) with ``torch.export`` at a fixed (n, t, h, w),
chunk and configuration, for one platform, ``cuda`` or ``cpu``. The
``ExportedProgram`` pins the geometry, the dtypes and the kernel operators
(``tecogan_torch::warp_planes``, and ``::warp_phases`` for ``packed16``), as
``jax.export`` pins StableHLO; ``torch.export.save`` serialises it.
``load_stream`` turns the bytes back into a callable
``(params, lr_seqs) -> uint8 (n, t, s*h, s*w, 3)`` that takes the fp32
weights, in the port's state-dict names, at call time; the program casts
them to its compute dtype, and weights or frames of another shape or dtype
fail its input checks. Loading imports torch and the port's kernels (which
register the operators), never its models: the serving host does not
rebuild the network from Python.

``torch.export`` rather than AOTInductor, which cannot call operators
registered from Python, or a bundle of weights and geometry, which would
rebuild the model from the port's code on the serving host.

A program for ``cuda`` is exported on a machine with a card: its
resampling matrices are made on the program's device while it is traced,
and become constants there (a program traced without a card would copy
them from the host at every use).

The file (``save_artifact``): the magic ``TECOSRVT`` (the JAX package's
artifacts start with ``TECOSRV1``, so each package refuses the other's),
then an npz holding the program's bytes (``blob``), ``meta`` (the repr of
a dict) and optionally the weights under ``params/``, in the JAX
package's names, flattened by ``utils/ckpt._flatten``, so that either
package's ``load_pytree`` reads them.
"""

from __future__ import annotations

import ast
import io

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from .nn import inference_numerics
# importing the kernels' modules registers their operators
from .ops import warp_cuda, warp_phases  # noqa: F401
from .utils import ckpt as ckpt_io
from .utils.layout import jax_from_state_dict, state_dict_from_jax

__all__ = ["export_stream", "load_stream", "save_artifact",
           "load_artifact", "read_artifact", "PLATFORMS"]

_MAGIC = b"TECOSRVT"
_PARAMS_NS = "params/"
# the program's own description, saved beside it by torch.export.save
_INFO = "tecogan_program"
PLATFORMS = ("cuda", "cpu")


def resolve_platform(platforms) -> str:
    """The one platform an artifact targets: ``platforms`` names exactly one
    of ``PLATFORMS``; None means ``cuda``, where the port runs."""
    if platforms is None:
        return "cuda"
    plats = tuple(str(p).lower() for p in platforms)
    if not plats:
        raise ValueError("platforms must name one platform, cuda or cpu, "
                         "or be None for cuda")
    if len(set(plats)) > 1:
        raise ValueError(f"export_stream targets exactly one platform per "
                         f"artifact (got {plats}); export separately per "
                         f"platform")
    if plats[0] not in PLATFORMS:
        raise ValueError(f"unknown platform {plats[0]!r}; expected one of "
                         f"{PLATFORMS}")
    return plats[0]


class _Stream(nn.Module):
    """``stream_frames`` as a module's forward, so that ``functional_call``
    can run it with the weights it is given."""

    def __init__(self, net, cfg, chunk: int):
        super().__init__()
        self.net, self.cfg, self.chunk = net, cfg, chunk

    def forward(self, lr_seqs):
        from .models.networks.frnet import stream_frames

        return stream_frames(self.net, lr_seqs, self.cfg, self.chunk)


class _Program(nn.Module):
    """What ``export_stream`` traces: (fp32 weights by name, lr_seqs) ->
    uint8 frames, the weights cast to the compute dtype inside. The FRNet
    lives on the meta device and outside the module tree, so the program
    holds no weights of its own."""

    def __init__(self, cfg, chunk: int):
        super().__init__()
        from .models.networks.frnet import FRNet

        with torch.device("meta"):
            net = FRNet(cfg)
        self.__dict__["stream"] = _Stream(net, cfg, chunk)
        self.dtype = cfg.dtype

    def forward(self, params: dict, lr_seqs: torch.Tensor) -> torch.Tensor:
        weights = {f"net.{k}": v.to(self.dtype) for k, v in params.items()}
        return functional_call(self.stream, weights, (lr_seqs,))


def export_stream(params, cfg, n: int, t: int, h: int, w: int,
                  chunk: int = 16, platforms=None) -> bytes:
    """Serialise the streaming program for ``n`` concurrent streams of ``t``
    frames at LR (h, w); returns the artifact bytes.

    ``params`` (the port's state dict) fixes only the names, shapes and
    dtypes of the weights: the serving process passes its own at call
    time. ``platforms``: the one target platform (``resolve_platform``).
    Exporting for ``cuda`` needs a CUDA device here.
    """
    platform = resolve_platform(platforms)
    if platform == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            "exporting for cuda needs a CUDA device on the exporting "
            "machine: the program's resampling matrices are made on its "
            "device while it is traced; export on a machine with a card, "
            "or for platforms=['cpu']")
    device = torch.device(platform)
    sd = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    lr = torch.zeros((n, t, h, w, 3), dtype=torch.float32, device=device)
    ep = torch.export.export(_Program(cfg, chunk), (sd, lr), strict=False)
    ep.example_inputs = None  # the zeros and weights need no place in the file
    info = {"compute_dtype": cfg.compute_dtype, "platform": platform,
            "keys": list(sd)}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_INFO: repr(info)})
    return buf.getvalue()


def load_stream(blob: bytes):
    """Deserialise an ``export_stream`` artifact -> callable
    ``(params, lr_seqs) -> uint8 (n, t, s*h, s*w, 3)`` on the program's
    device. ``params`` maps the port's weight names to fp32 arrays or
    tensors (moved to the device); ``lr_seqs`` is float32 (n, t, h, w, 3).
    A float32 program runs with TF32 off and cuDNN's deterministic
    algorithms, as the live path does (``nn.inference_numerics``)."""
    extra = {_INFO: ""}
    ep = torch.export.load(io.BytesIO(bytes(blob)), extra_files=extra)
    info = ast.literal_eval(extra[_INFO])
    device = torch.device(info["platform"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this artifact runs on cuda, and there is no "
                           "CUDA device here")
    module = ep.module()
    keys = info["keys"]

    def run(params, lr_seqs):
        missing = [k for k in keys if k not in params]
        extra_keys = [k for k in params if k not in keys]
        if missing or extra_keys:
            raise ValueError(f"the program takes the weights {len(keys)} "
                             f"names; missing {missing[:5]}, unknown "
                             f"{extra_keys[:5]}")
        weights = {k: torch.as_tensor(params[k], device=device)
                   for k in keys}
        lr = torch.as_tensor(lr_seqs, device=device)
        with torch.inference_mode(), inference_numerics(
                info["compute_dtype"]):
            return module(weights, lr)

    return run


def save_artifact(path: str, blob: bytes, meta: dict | None = None,
                  params=None) -> None:
    """Write the artifact with its npz sidecar (geometry and configuration)
    so a serving host can check its inputs before calling.

    ``params``: the port's state dict to embed, making the file a
    self-contained serving bundle (``python -m tecogan_tpu_torch.serve``
    runs from it alone); they are stored in the JAX package's names. Raises
    ValueError where they do not flatten under ``params/``, instead of
    dropping them. Omit them to ship a weights-free artifact whose host
    supplies a checkpoint.
    """
    extra = {}
    if params is not None:
        if not isinstance(params, dict):
            raise ValueError(f"params must be the generator's state dict, "
                             f"got {type(params).__name__}")
        extra = ckpt_io._flatten(jax_from_state_dict(params), _PARAMS_NS)
        if not extra or any(not k.startswith(_PARAMS_NS) for k in extra):
            raise ValueError(f"the weights do not flatten under "
                             f"{_PARAMS_NS!r}: {sorted(extra)[:5]}")
    buf = io.BytesIO()
    np.savez(buf, blob=np.frombuffer(blob, np.uint8),
             meta=np.asarray(repr(meta or {})), **extra)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(buf.getvalue())


def load_artifact(path: str):
    """Read a ``save_artifact`` file -> (callable, meta dict, params).

    ``params`` is the embedded weights as the port's state dict (CPU
    tensors), or None for a weights-free artifact (the caller then
    supplies its own checkpoint, same names and shapes)."""
    blob, meta, params = read_artifact(path)
    return load_stream(blob), meta, params


def read_artifact(path: str):
    """A ``save_artifact`` file -> (program bytes, meta dict, params), the
    program not yet deserialised (``load_stream`` takes seconds at 64
    frames), so a host can check its inputs against ``meta`` first."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(
                f"{path} is not a tecogan_tpu_torch serving artifact (bad "
                f"magic {magic!r})")
        data = f.read()
    z = np.load(io.BytesIO(data), allow_pickle=False)
    meta = ast.literal_eval(str(z["meta"]))
    flat = {k[len(_PARAMS_NS):]: z[k] for k in z.files
            if k.startswith(_PARAMS_NS)}
    params = state_dict_from_jax(ckpt_io._unflatten(flat)) if flat else None
    return z["blob"].tobytes(), meta, params
