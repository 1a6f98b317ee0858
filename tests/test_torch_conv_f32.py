"""The discriminator's fp32 forwards from float64 operands
(``nn.F64ForwardConv2d``, ``nn.conv2d_f64_forward``), which an fp32
training step takes on every device, and the fp32 pass audit
(``tools/conv_audit.py``) that ``chip_smoke.py::phase_f32_conv_audit``
runs on the card.

The route's forward is bit for bit ``F.conv2d`` in float64 rounded once
to fp32 (and within 1e-6 relative L2 of ``F.conv2d`` in fp32); its input
and weight gradients are bit for bit autograd's through ``F.conv2d`` (the
same ``convolution_backward`` call on the same fp32 operands).
"""

import importlib.util
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tecogan_tpu.models.losses import vanilla_gan_loss
from tecogan_tpu.models.networks.discriminators import trunk_apply
from tecogan_tpu_torch import nn as tnn
from tecogan_tpu_torch.models import convert
from tecogan_tpu_torch.tools import bench_suite, conv_audit
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# D's fp32 gradients against float64 on d_band.py's inputs, the band of
# tests/test_torch_d_band.py (JAX's fp32 D and the port's CPU fp32 alike)
FP32_REL = 3e-5
# D's convolutions at phase 13's STNet of 64^2, batch 2: (input, weight,
# stride, padding, bias)
D_CONVS = {"conv_in": ((2, 27, 64, 64), (64, 27, 3, 3), 1, 1, True),
           "block1": ((2, 64, 64, 64), (64, 64, 4, 4), 2, 1, False),
           "block2": ((2, 64, 32, 32), (64, 64, 4, 4), 2, 1, False),
           "block3": ((2, 64, 16, 16), (128, 64, 4, 4), 2, 1, False),
           "block4": ((2, 128, 8, 8), (256, 128, 4, 4), 2, 1, False)}


@pytest.fixture
def from_zero(monkeypatch):
    """The route's call count from zero."""
    monkeypatch.setattr(tnn.conv2d_f64_forward, "calls", 0)


def _module(name):
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        name, osp.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def d_band():
    return _module("d_band")


@pytest.fixture(scope="module")
def failing(d_band):
    """d_band.py's D state dict and real and fake inputs."""
    return d_band.d_inputs()


@pytest.mark.parametrize("layer", list(D_CONVS))
def test_route_passes_at_the_d_shapes(from_zero, layer):
    """Forward: float64's result rounded once, bit for bit, and within
    1e-6 of fp32's; input and weight gradient: bit for bit autograd's."""
    xs, ws, stride, pad, has_bias = D_CONVS[layer]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(xs, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(ws, dtype=np.float32) * 0.05)
    b = (torch.from_numpy(rng.standard_normal(ws[0], dtype=np.float32))
         if has_bias else None)
    conv = tnn.F64ForwardConv2d(ws[1], ws[0], ws[2], stride, pad,
                                bias=has_bias)
    with torch.no_grad():
        conv.weight.copy_(w)
        if has_bias:
            conv.bias.copy_(b)
    xa = x.clone().requires_grad_()
    with tnn.training_numerics(mixed_precision=False):
        out = conv(xa)
    assert tnn.conv2d_f64_forward.calls == 1
    wide = F.conv2d(x.double(), w.double(), None if b is None else
                    b.double(), stride, pad)
    assert out.dtype == torch.float32 and torch.equal(out, wide.float())
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    plain = F.conv2d(xb, wb, b, stride, pad)
    assert conv_audit.rel_l2(plain.detach(), wide) <= 1e-6
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape),
                                             dtype=np.float32))
    out.backward(g)
    plain.backward(g)
    assert torch.equal(xa.grad, xb.grad)
    assert torch.equal(conv.weight.grad, wb.grad)


def test_d_phase_through_the_route_matches_jax_fp32(failing, from_zero,
                                                   d_band):
    """On d_band.py's inputs, D's fp32 phase with its five convolutions
    on the route (two forwards: 10 calls): every gradient within FP32_REL
    of float64 and of the JAX package's fp32 ``trunk_apply``; no
    LeakyReLU input on the other side of its kink from float64's."""
    sd, xr, xf = failing
    ref = d_band.d_grads(sd, xr, xf, "cpu", torch.float64)
    got = d_band.d_grads(sd, xr, xf, "cpu",
                         numerics=tnn.training_numerics(False))
    assert tnn.conv2d_f64_forward.calls == 10
    err = {k: conv_audit.rel_l2(got[k], v) for k, v in ref.items()}
    assert max(err.values()) <= FP32_REL, err

    params = jax.tree.map(jnp.asarray, convert.jax_from_d_state_dict(sd, 64))
    xr_j, xf_j = (jnp.asarray(x.permute(0, 2, 3, 1).numpy())
                  for x in (xr, xf))

    def loss(p):
        real, _, _ = trunk_apply(p, xr_j, train=True)
        fake, _, _ = trunk_apply(p, xf_j, train=True)
        return vanilla_gan_loss(real, True) + vanilla_gan_loss(fake, False)

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
    jx = convert.d_state_dict_from_jax(grads, 64)
    err = {k: conv_audit.rel_l2(
        got[k], torch.as_tensor(np.asarray(jx[k]), dtype=torch.float64))
        for k in ref}
    assert max(err.values()) <= FP32_REL, err

    kref = d_band.cs._kink_inputs(sd, xr, xf, "cpu", torch.float64)
    kgot = d_band.cs._kink_inputs(sd, xr, xf, "cpu",
                                  numerics=tnn.training_numerics(False))
    assert d_band.cs._kink_flips("CPU fp32, the route", kgot, kref) == 0


def test_one_input_across_block1s_kink_moves_its_bias_gradient(failing,
                                                                 d_band):
    """Why the card once read 4.91e-3 at block 1's BatchNorm bias on
    these inputs: in float64 a LeakyReLU input of block 1 lies within
    1e-5 of the kink, where fp32 rounding of the forward (about 5e-7
    relative on the card, 2.7e-7 on the CPU) can put it on the other side;
    that one input moved across zero, everything else float64, moves the
    bias gradient by more than phase 13's band of 1e-3."""
    sd, xr, xf = failing
    ref = d_band.d_grads(sd, xr, xf, "cpu", torch.float64)
    y = d_band.cs._kink_inputs(sd, xr, xf, "cpu", torch.float64)[1][0]
    i = int(y.abs().flatten().argmin())
    assert abs(float(y.flatten()[i])) < 1e-5
    calls = []

    def across(module, args, out):
        calls.append(1)
        if len(calls) > 1:
            return out
        flat = out.flatten().clone()
        flat[i] = -flat[i]
        return flat.view_as(out)

    net = d_band._net(sd, "cpu", torch.float64)
    net.get_submodule("discriminator_block.block1.1").register_forward_hook(
        across)
    from tecogan_tpu_torch.models.losses import define_criterion

    crit = define_criterion(d_band.cs._gan_cmp_config(False).gan_crit)
    (crit(net(xr.double())[0], True)
     + crit(net(xf.double())[0], False)).backward()
    got = net.get_parameter(d_band.TAG).grad
    assert conv_audit.rel_l2(got, ref[d_band.TAG]) > 1e-3


@pytest.mark.parametrize("mixed, calls", [(False, 15), (True, 0)])
def test_only_an_fp32_step_enters_the_route(from_zero, mixed, calls):
    """A TecoGAN step at toy width runs D forward three times (the D
    phase's real and fake, the G phase's fake): in fp32 each of its five
    convolutions takes the route, in bf16 none; chip_smoke's
    ``_route_count`` reads the same."""
    cs = _module("chip_smoke")
    step, state, batch = bench_suite.build_train_case(
        "tecogan", mixed_precision=mixed, device="cpu", nf=8, nb=1,
        batch=1, frames=3, gt_size=32)
    with cs._route_count() as routed:
        step(state, batch)
    assert tnn.conv2d_f64_forward.calls == calls == routed[1]
    assert mixed or routed[0] == calls


def test_training_numerics_scopes_the_route():
    """Only an fp32 step's settings turn the route on, on the CPU as on a
    card, and they restore the setting around them; a forward outside a
    step, or in a bf16 step, is ``nn.Conv2d``'s."""
    conv, x = tnn.F64ForwardConv2d(3, 4, 3), torch.ones(1, 3, 8, 8)
    calls = tnn.conv2d_f64_forward.calls
    assert not tnn._F64_FORWARD["on"]
    with tnn.training_numerics(mixed_precision=True):
        assert not tnn._F64_FORWARD["on"]
        conv(x)
    assert tnn.conv2d_f64_forward.calls == calls
    with tnn.training_numerics(mixed_precision=False):
        assert tnn._F64_FORWARD["on"]
        with tnn.training_numerics(mixed_precision=False):
            assert tnn._F64_FORWARD["on"]
        assert tnn._F64_FORWARD["on"]
        conv(x)
        assert tnn.conv2d_f64_forward.calls == calls + 1
    assert not tnn._F64_FORWARD["on"]
    conv(x)
    assert tnn.conv2d_f64_forward.calls == calls + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
def test_route_raises_rather_than_running_another_dtype(from_zero, dtype):
    """The route takes fp32 operands: an fp32 input against a weight of
    another dtype raises inside a step, as does a direct call."""
    conv = tnn.F64ForwardConv2d(3, 4, 3).to(dtype)
    with tnn.training_numerics(mixed_precision=False), \
            pytest.raises(TypeError, match="fp32 operands"):
        conv(torch.ones(1, 3, 8, 8))
    with pytest.raises(TypeError, match="fp32 operands"):
        tnn.conv2d_f64_forward(torch.ones(1, 3, 8, 8, dtype=dtype),
                               torch.ones(4, 3, 3, 3, dtype=dtype), None,
                               1, 1, 1, 1)


@pytest.mark.parametrize("model", ["frvsr", "tecogan"])
def test_audit_on_the_cpu_against_itself(model):
    """The audit's capture and recompute over a toy fp32 step on the CPU,
    the CPU standing for the card: every (layer, pass) recorded, each
    inside chip_smoke's band (the recorded result is the CPU's own fp32),
    D's forwards within one rounding of float64, and every kind of pass of
    the step there."""
    cs = _module("chip_smoke")
    step, state, batch = bench_suite.build_train_case(
        model, device="cpu", nf=8, nb=1, batch=1, frames=3, gt_size=32)
    rec = conv_audit.PassRecorder(max_calls=2)
    rec.watch("g", state["g"])
    if model == "tecogan":
        rec.watch("d", state["d"])
    with rec:
        step(state, batch)
    rows = conv_audit.audit(rec.calls, cs.F32_PASS_FACTOR,
                            cs.F32_PASS_FLOOR, rounded_once=cs._from_float64)
    assert rows and all(r["ok"] for r in rows), [r for r in rows
                                                 if not r["ok"]]
    once = [r["rounding"] for r in rows if r["rounding"] is not None]
    assert len(once) == (5 if model == "tecogan" else 0)
    assert all(v <= 1.0 for v in once), once
    kinds = {(r["kind"], r["pass"]) for r in rows}
    want = {(k, p) for k in ("conv2d", "conv_transpose2d")
            for p in ("forward", "dgrad", "wgrad")}
    if model == "tecogan":
        want |= {("linear", p) for p in ("forward", "dgrad", "wgrad")}
    assert kinds == want
    assert all(r["calls"] <= 2 for r in rows)
    assert not rec._hooks


def test_audit_sees_d_forwards_that_are_not_from_float64():
    """With D's forwards as ``nn.Conv2d``'s in the fp32 step (the route
    off: the CPU's fp32 convolution), the audit puts each of D's five
    convolution forwards outside one rounding of float64, while their
    relative L2 band, which cannot tell the two apart, holds."""
    cs = _module("chip_smoke")
    step, state, batch = bench_suite.build_train_case(
        "tecogan", device="cpu", nf=8, nb=1, batch=1, frames=3, gt_size=32)
    rec = conv_audit.PassRecorder(max_calls=1).watch("d", state["d"])
    with rec, cs._cudnn_forwards():
        step(state, batch)
    rows = conv_audit.audit(rec.calls, cs.F32_PASS_FACTOR,
                            cs.F32_PASS_FLOOR, rounded_once=cs._from_float64)
    once = [r for r in rows if r["rounding"] is not None]
    assert len(once) == 5
    assert all(r["rounding"] > 1.0 and not r["ok"] for r in once), once
    assert all(r["device"] <= r["band"] for r in rows)
    assert all(r["ok"] for r in rows if r["rounding"] is None)


@pytest.mark.parametrize("shape", [(7,), (3, 64, 5, 5)])
def test_roundings_counts_one_fp32_rounding(shape):
    """``conv_audit.roundings``: float64 values over twelve decades
    rounded once to fp32 read at most 1; the largest of them two ulps
    further away (at least 1.5 ulps from float64) more than 1."""
    rng = np.random.default_rng(1)
    ref = torch.from_numpy(rng.standard_normal(shape) * 10.0 ** rng.integers(
        -6, 6, shape))
    got = ref.float()
    assert conv_audit.roundings(got, ref) <= 1.0
    flat = got.flatten().clone()
    i = int(flat.abs().argmax())
    for _ in range(2):
        flat[i] = torch.nextafter(flat[i], flat[i] * 2)
    assert conv_audit.roundings(flat.view(shape), ref) > 1.0
