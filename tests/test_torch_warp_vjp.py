"""Port parity for the training warp (K2 forward, K3/K4 adjoints): the
plain versions the CUDA kernels are held against on the card, and the
autograd ``backward_warp_diff``, against the TPU kernels in interpret mode
and ``jax.vjp`` of the JAX ``backward_warp_diff`` (CPU)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu.ops.warp_pallas import backward_warp_rgb
from tecogan_tpu.ops.warp_vjp import _dflow, _dimage
from tecogan_tpu.ops.warp_vjp import backward_warp_diff as jwarp_diff
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.ops import warp_cuda, warp_vjp
from tecogan_tpu_torch.ops.warp_cuda import (warp_planes,
                                             warp_planes_reference, warp_rgb)
from tecogan_tpu_torch.ops.warp_vjp import (backward_warp_diff, warp_dflow,
                                            warp_dflow_reference,
                                            warp_dimage,
                                            warp_dimage_reference)

# tests/test_warp_vjp.py's shapes, (n, h, w, c)
_SHAPES = [(2, 32, 48, 3), (1, 17, 23, 3), (2, 40, 128, 3), (1, 64, 128, 3)]
_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, shape, scale=9.0):
    """tests/test_warp_vjp.py's inputs: interior flows, out-of-range flows
    at two corners and, for 32-aligned heights, the roll-alias rows."""
    n, h, w, c = shape
    x = rng.random((n, h, w, c)).astype(np.float32)
    flow = ((rng.random((n, h, w, 2)) - 0.5) * scale).astype(np.float32)
    flow[:, :3, :3] = 25.0
    flow[:, -2:, -2:] = -30.0
    if h % 32 == 0:
        flow[:, h - 32:h - 28, :, 1] = float(h)
    g = rng.standard_normal((n, h, w, c)).astype(np.float32)
    return x, flow, g


def _nchw(a, dtype=torch.float32):
    """NHWC numpy -> the logically NCHW channels_last view of it."""
    return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _to_bf16_torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).bfloat16()


@pytest.mark.parametrize("shape", _SHAPES)
def test_k2_plain_matches_pallas_interpret(rng, shape):
    x, flow, _ = _inputs(rng, shape)
    want = np.asarray(backward_warp_rgb(jnp.asarray(x), jnp.asarray(flow),
                                        interpret=True))
    xt, ft = _nchw(x), torch.from_numpy(flow)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    got = warp_rgb(xt, ft)
    np.testing.assert_allclose(_nhwc(got), want, **_TOL)
    # NCHW-contiguous input: the same values
    torch.testing.assert_close(warp_rgb(xt.contiguous(), ft), got, rtol=0,
                               atol=0)


@pytest.mark.parametrize("shape", _SHAPES)
def test_k3_plain_matches_pallas_interpret(rng, shape):
    _, flow, g = _inputs(rng, shape)
    n, h, w, c = shape
    want = np.asarray(_dimage(jnp.asarray(g), jnp.asarray(flow), c, h, w,
                              interpret=True))
    got = warp_dimage_reference(_nchw(g), torch.from_numpy(flow),
                                torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), want, **_TOL)


@pytest.mark.parametrize("shape", _SHAPES)
def test_k4_plain_matches_pallas_interpret(rng, shape):
    x, flow, g = _inputs(rng, shape)
    want = np.asarray(_dflow(jnp.asarray(g), jnp.asarray(x),
                             jnp.asarray(flow), interpret=True))
    got = warp_dflow_reference(_nchw(g), _nchw(x), torch.from_numpy(flow))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_TOL)


def _jax_vjp(x, flow, g):
    out, pull = jax.vjp(lambda a, f: jwarp_diff(a, f, interpret=True), x,
                        flow)
    dx, dflow = pull(g)
    return out, dx, dflow


def _torch_vjp(x, flow, g):
    x = x.detach().requires_grad_(True)
    flow = flow.detach().requires_grad_(True)
    out = backward_warp_diff(x, flow)
    out.backward(g)
    return out, x.grad, flow.grad


@pytest.mark.parametrize("shape", _SHAPES)
def test_backward_warp_diff_matches_jax_vjp(rng, shape):
    x, flow, g = _inputs(rng, shape)
    out_w, dx_w, df_w = _jax_vjp(jnp.asarray(x), jnp.asarray(flow),
                                 jnp.asarray(g))
    out, dx, df = _torch_vjp(_nchw(x), torch.from_numpy(flow), _nchw(g))
    np.testing.assert_allclose(_nhwc(out), np.asarray(out_w), **_TOL)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(dx_w), **_TOL)
    np.testing.assert_allclose(df.numpy(), np.asarray(df_w), **_TOL)


@pytest.mark.parametrize("flow_bf16", [False, True])
def test_backward_warp_diff_bf16_matches_jax_vjp(rng, flow_bf16):
    """Mixed precision: a bf16 image (and optionally a bf16 flow, read as
    fp32); value and image gradient in bf16 within 1 ulp, the flow
    gradient in the flow's dtype."""
    x, flow, g = _inputs(rng, (2, 33, 40, 3), scale=7.0)
    xj = jnp.asarray(x, jnp.bfloat16)
    gj = jnp.asarray(g, jnp.bfloat16)
    fj = jnp.asarray(flow, jnp.bfloat16 if flow_bf16 else jnp.float32)
    out_w, dx_w, df_w = _jax_vjp(xj, fj, gj)
    assert out_w.dtype == dx_w.dtype == jnp.bfloat16
    assert df_w.dtype == fj.dtype

    xt = _to_bf16_torch(xj).permute(0, 3, 1, 2)
    gt = _to_bf16_torch(gj).permute(0, 3, 1, 2)
    ft = _to_bf16_torch(fj) if flow_bf16 else torch.from_numpy(flow)
    out, dx, df = _torch_vjp(xt, ft, gt)
    assert out.dtype == dx.dtype == torch.bfloat16 and df.dtype == ft.dtype
    assert _bf16_ulps(out.permute(0, 2, 3, 1), _to_bf16_torch(out_w)) <= 1
    assert _bf16_ulps(dx.permute(0, 2, 3, 1), _to_bf16_torch(dx_w)) <= 1
    if flow_bf16:
        assert _bf16_ulps(df, _to_bf16_torch(df_w)) <= 1
    else:
        np.testing.assert_allclose(df.numpy(), np.asarray(df_w), **_TOL)


def test_image_adjoint_skipped_for_data(rng, monkeypatch):
    """The warping loss warps data: with an image that needs no gradient
    the image adjoint (K3) is never computed; the flow's (K4) is."""
    calls = []
    real = warp_vjp.warp_dimage
    monkeypatch.setattr(warp_vjp, "warp_dimage",
                        lambda *a: calls.append(1) or real(*a))
    x, flow, g = _inputs(rng, (1, 17, 23, 3))
    xt = _nchw(x)
    ft = torch.from_numpy(flow).requires_grad_(True)
    backward_warp_diff(xt, ft).backward(_nchw(g))
    assert calls == [] and xt.grad is None
    torch.testing.assert_close(
        ft.grad, warp_dflow_reference(_nchw(g), xt, ft.detach()),
        rtol=0, atol=0)
    xg = xt.detach().requires_grad_(True)
    backward_warp_diff(xg, ft.detach()).backward(_nchw(g))
    assert calls == [1] and xg.grad is not None


def test_cpu_dispatch_counts_no_launch(rng):
    x, flow, g = _inputs(rng, (1, 17, 23, 3))
    xt, ft, gt = _nchw(x), torch.from_numpy(flow), _nchw(g)
    before = (warp_rgb.launches, warp_dimage.launches, warp_dflow.launches)
    torch.testing.assert_close(warp_rgb(xt, ft),
                               warp_planes_reference(xt, ft), rtol=0, atol=0)
    torch.testing.assert_close(warp_dimage(gt, ft, torch.bfloat16),
                               warp_dimage_reference(gt, ft, torch.bfloat16),
                               rtol=0, atol=0)
    torch.testing.assert_close(warp_dflow(gt, xt, ft),
                               warp_dflow_reference(gt, xt, ft),
                               rtol=0, atol=0)
    assert (warp_rgb.launches, warp_dimage.launches,
            warp_dflow.launches) == before


@pytest.mark.parametrize("fn", ["warp_rgb", "warp_dimage", "warp_dflow"])
@pytest.mark.parametrize("img_dev,flow_dev", [("meta", "meta"),
                                              ("cpu", "meta"),
                                              ("meta", "cpu")])
def test_non_cpu_non_cuda_tensors_raise(fn, img_dev, flow_dev):
    """Only CPU tensors take the plain versions; anything else goes to a
    kernel or raises."""
    img = torch.empty(1, 3, 8, 8, device=img_dev)
    flow = torch.empty(1, 8, 8, 2, device=flow_dev)
    call = {"warp_rgb": lambda: warp_rgb(img, flow),
            "warp_dimage": lambda: warp_dimage(img, flow, torch.float32),
            "warp_dflow": lambda: warp_dflow(img, img, flow)}[fn]
    with pytest.raises(ValueError):
        call()


def test_kernel_sources_export_every_dtype_pair():
    """Every (image, flow) dtype pair the wrappers can ask for exists as a C
    entry point in the CUDA sources."""
    rgb = (kernel_build.CSRC_DIR / "warp_rgb.cu").read_text()
    vjp = (kernel_build.CSRC_DIR / "warp_vjp.cu").read_text()
    for a in warp_cuda._DTYPE_TAG.values():
        for b in warp_cuda._DTYPE_TAG.values():
            assert f"TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_{a}_{b}," in rgb
            assert f"TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_{a}_{b}," in vjp
            assert f"TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_{a}_{b}," in vjp


# each kernel's C launcher that reads the packed arguments: (source, name)
_LAUNCHERS = {"K1": ("warp_planes.cu", "launch_kernel"),
              "K1 band": ("warp_planes.cu", "launch_kernel"),
              "K2": ("warp_rgb.cu", "launch"),
              "K3": ("warp_vjp.cu", "launch_dimage"),
              "K4": ("warp_vjp.cu", "launch_dflow"),
              "K5": ("warp_phases.cu", "launch_kernel")}


@pytest.mark.parametrize("kernel", sorted(_LAUNCHERS))
def test_wrappers_pack_what_the_c_launchers_read(monkeypatch, rng, kernel):
    """Each wrapper hands its C entry point one int64 array: the stream
    lands where the launcher reads it (``arg_ptr<CUstream_st>(a, k)``),
    and every ``strides_from(a + k)`` reads the element strides of the
    tensor it stands for. The wrappers run on CPU tensors with the device
    checks and the launch stubbed out."""
    from tecogan_tpu_torch.ops import warp_phases as wp

    calls = []
    for mod in (warp_cuda, warp_vjp, wp):
        monkeypatch.setattr(mod, "all_on_cpu", lambda *t: False)
        monkeypatch.setattr(mod, "launch",
                            lambda name, index, *a: calls.append(a))
    monkeypatch.setattr(warp_cuda, "cuda_index", lambda name, *t: 0)
    monkeypatch.setattr(wp, "cuda_index", lambda name, *t: 0)

    x = torch.randn(2, 3, 8, 12)
    g = torch.randn(2, 3, 8, 12)
    flow = torch.randn(2, 2, 8, 12).permute(0, 2, 3, 1)  # an NCHW view
    sy = torch.rand(1, 4, 4, 6)
    sx = torch.rand(1, 4, 6, 4).transpose(2, 3)
    channels_last = x.contiguous(memory_format=torch.channels_last)
    f32 = torch.float32
    run, strides = {
        "K1": (lambda: warp_planes(x, flow), [flow]),
        "K1 band": (lambda: warp_planes(x, flow, 4, 3), [flow]),
        "K2": (lambda: warp_rgb(channels_last, flow),
               [channels_last, channels_last, flow]),
        "K3": (lambda: warp_dimage(g, flow, torch.bfloat16),
               [g, torch.zeros_like(g, dtype=f32), flow]),
        "K4": (lambda: warp_dflow(g, x, flow), [g, x, flow]),
        "K5": (lambda: wp.warp_phases(
            wp.phase_planes(torch.randn(1, 3, 8, 12), 2), sy, sx, 2),
            [sy, sx]),
    }[kernel]
    run()
    (args,) = calls
    source, name = _LAUNCHERS[kernel]
    text = (kernel_build.CSRC_DIR / source).read_text()
    body = re.search(rf"\nint {name}\(const int64_t\* a\) \{{(.*?)\n\}}",
                     text, re.S).group(1)
    (stream,) = re.findall(r"arg_ptr<CUstream_st>\(a, (\d+)\)", body)
    assert len(args) == int(stream)
    offsets = [int(k) for k in re.findall(r"strides_from\(a \+ (\d+)\)",
                                          body)]
    assert [tuple(args[k:k + 4]) for k in offsets] == [
        t.stride() for t in strides]
