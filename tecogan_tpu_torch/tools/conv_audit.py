"""Every fp32 convolution and linear pass of a training step, held against
float64 on the CPU.

``PassRecorder`` is a dispatch mode. Inside it, each fp32 call of a
watched network's layers is copied to the CPU with the device's result:
a ``conv2d``, ``conv_transpose2d`` or linear layer's forward (by a forward
hook on the layer), a convolution's input gradient and weight gradient
(``aten.convolution_backward``), and a linear layer's (``mm``). ``audit``
recomputes each pass on the CPU from the same operands, in float64 (the
reference) and in fp32, and returns one row per (layer, pass): the
device's relative L2 distance from float64 against the CPU fp32's, on the
call where the device is furthest outside its band, max(``factor`` x the
CPU fp32's, ``floor``).
A pass that the device computes from float64 operands and rounds once
(``rounded_once``) is held, besides, element by element to one rounding
of the float64 result.

    rec = PassRecorder(max_calls=3)
    rec.watch("g", net_g)
    with rec:
        ...  # one fp32 step on the card
    rows = audit(rec.calls, factor=4.0, floor=1e-5,
                 rounded_once=lambda layer, kind, p: layer.startswith("d.")
                 and kind == "conv2d" and p == "forward")

``chip_smoke.py::phase_f32_conv_audit`` runs it on one FRVSR and one GAN
step on the card.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["Call", "PassRecorder", "audit", "rel_l2", "roundings"]


@dataclasses.dataclass
class Call:
    """One recorded call: the layer, its kind ("conv2d",
    "conv_transpose2d", "linear"), the aten overload and its arguments as
    CPU copies, and {pass: (index of the pass in the overload's outputs,
    the device's result as a CPU copy)}."""
    layer: str
    kind: str
    func: object
    args: tuple
    results: dict


def _ptr(t) -> int:
    return t.untyped_storage().data_ptr() if isinstance(t, torch.Tensor) \
        else -1


def _cpu(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True)
    if isinstance(a, (list, tuple)):
        return type(a)(_cpu(x) for x in a)
    return a


def _f32(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype == torch.float32


class PassRecorder(TorchDispatchMode):
    """Records the fp32 passes of the layers of the networks given to
    ``watch``, at most ``max_calls`` calls of each (layer, pass) (None: every
    call). A forward is recorded by a forward hook on its layer (its input,
    weight, bias and output: what the layer hands on, whichever route
    computed it); the gradients by their aten calls, where a layer is known
    by its weight's storage, so a weight passed through ``functional_call``,
    detached or viewed is still its layer's. Weights cast to another dtype
    are not fp32 and are not recorded."""

    def __init__(self, max_calls: int | None = None):
        super().__init__()
        self.max_calls = max_calls
        self.calls: list[Call] = []
        self._layers: dict[int, tuple[str, str, tuple]] = {}
        self._linear_inputs: dict[int, str] = {}
        self._count = collections.Counter()
        self._hooks = []
        self._active = False

    def watch(self, prefix: str, net: nn.Module) -> "PassRecorder":
        for name, m in net.named_modules():
            if isinstance(m, nn.ConvTranspose2d):
                kind = "conv_transpose2d"
                fn = functools.partial(
                    F.conv_transpose2d, stride=m.stride, padding=m.padding,
                    output_padding=m.output_padding, groups=m.groups,
                    dilation=m.dilation)
            elif isinstance(m, nn.Conv2d):
                kind = "conv2d"
                fn = functools.partial(
                    F.conv2d, stride=m.stride, padding=m.padding,
                    dilation=m.dilation, groups=m.groups)
            elif isinstance(m, nn.Linear):
                kind, fn = "linear", F.linear
            else:
                continue
            layer = f"{prefix}.{name}"
            self._layers[_ptr(m.weight)] = (layer, kind,
                                            tuple(m.weight.shape))
            self._hooks.append(m.register_forward_hook(
                functools.partial(self._forward, layer, kind, fn)))
        return self

    def __enter__(self):
        self._active = True
        return super().__enter__()

    def __exit__(self, *exc):
        self._active = False
        for h in self._hooks:
            h.remove()
        self._hooks = []
        return super().__exit__(*exc)

    def _want(self, layer, passes):
        if self.max_calls is None:
            return list(passes)
        return [p for p in passes if self._count[layer, p] < self.max_calls]

    def _record(self, layer, kind, func, args, out, passes):
        """``passes``: {pass: index of its result in ``out``}."""
        keep = self._want(layer, passes)
        if not keep:
            return
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for p in keep:
            self._count[layer, p] += 1
        self.calls.append(Call(layer, kind, func, _cpu(tuple(args)),
                               {p: (passes[p], _cpu(outs[passes[p]]))
                                for p in keep}))

    def _forward(self, layer, kind, fn, module, args, out):
        x, w, b = args[0], module.weight, module.bias
        if not (self._active and _f32(x) and _f32(w)):
            return
        if kind == "linear":
            # the weight gradient's mm takes this x again
            self._linear_inputs[_ptr(x)] = layer
        self._record(layer, kind, fn, (x, w, b), out, {"forward": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if kwargs:
            return out
        if name == "convolution_backward" and _f32(args[0]) \
                and _f32(args[2]):
            layer = self._layers.get(_ptr(args[2]))
            mask = args[10]
            passes = {p: i for i, p in ((0, "dgrad"), (1, "wgrad"))
                      if mask[i]}
            if layer is not None and passes:
                self._record(*layer[:2], func, args, out, passes)
        elif name == "mm" and all(map(_f32, args)):
            self._linear_grad(func, args, out)
        return out

    def _linear_grad(self, func, args, out):
        a, b = args
        layer = self._layers.get(_ptr(b))
        if layer is not None and layer[1] == "linear":
            # mm(g, W): the input gradient (mm(x, W.t()), a forward
            # without a bias, has W's transpose)
            if tuple(b.shape) == layer[2]:
                self._record(*layer[:2], func, args, out, {"dgrad": 0})
            return
        # the weight gradient: mm(x.t(), g), or mm(g.t(), x) for the
        # column-major W.t() of a linear layer's forward
        for t in (a, b):
            if _ptr(t) in self._linear_inputs:
                self._record(self._linear_inputs[_ptr(t)], "linear", func,
                             args, out, {"wgrad": 0})
                return


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| in float64 (0 where both are zero)."""
    got, ref = got.double(), ref.double()
    den = float(ref.norm())
    num = float((got - ref).norm())
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return num / den


def roundings(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| over one fp32 rounding of ``ref``, 2^-24 |ref|
    (with 2^-40 of ref's largest magnitude for two float64 results that
    differ in their last bits, and 2^-149 for subnormals), in float64: at
    most 1 where ``got`` is ``ref`` rounded once to fp32."""
    got, ref = got.double(), ref.double()
    if ref.numel() == 0:
        return 0.0
    one = (2.0 ** -24 * ref.abs() + 2.0 ** -40 * float(ref.abs().max())
           + 2.0 ** -149)
    return float(((got - ref).abs() / one).max())


def _run(call: Call, dtype):
    args = tuple(a.to(dtype) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in call.args)
    out = call.func(*args)
    return out if isinstance(out, (tuple, list)) else (out,)


def audit(calls, factor: float, floor: float,
          rounded_once=None) -> list[dict]:
    """One row per (layer, pass) of ``calls``, in the order first seen:
    ``layer``, ``kind``, ``pass``, ``calls`` (how many were checked),
    ``device`` and ``cpu`` (the relative L2 distances from float64 of the
    device's and the CPU fp32's result on the call furthest outside its
    band), ``band`` (max(factor x cpu, floor) on that call), ``rounding``
    (where ``rounded_once(layer, kind, pass)`` is true, the largest
    ``roundings`` of the device's result over its calls, else None) and
    ``ok`` (every call inside its band, and ``rounding`` at most 1). Runs
    at the CPU's own thread count."""
    rows: dict = {}
    with torch.no_grad():
        for call in calls:
            ref, f32 = _run(call, torch.float64), _run(call, torch.float32)
            for p, (i, got) in call.results.items():
                dev, cpu = rel_l2(got, ref[i]), rel_l2(f32[i], ref[i])
                band = max(factor * cpu, floor)
                once = rounded_once is not None and rounded_once(
                    call.layer, call.kind, p)
                row = rows.setdefault((call.layer, p), {
                    "layer": call.layer, "kind": call.kind, "pass": p,
                    "calls": 0, "device": 0.0, "cpu": 0.0, "band": floor,
                    "rounding": 0.0 if once else None, "ok": True,
                    "_excess": -float("inf")})
                row["calls"] += 1
                row["ok"] = row["ok"] and dev <= band
                if once:
                    r = roundings(got, ref[i])
                    row["rounding"] = max(row["rounding"], r)
                    row["ok"] = row["ok"] and r <= 1.0
                if dev / band > row["_excess"]:
                    row.update(device=dev, cpu=cpu, band=band,
                               _excess=dev / band)
    out = []
    for row in rows.values():
        row.pop("_excess")
        out.append(row)
    return out
