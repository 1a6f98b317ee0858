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
                                            warp_dimage, warp_dimage_dflow,
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
    the image adjoint (K3) is never computed, and the flow's (K4) alone;
    with both gradients wanted, one fused call computes the two."""
    calls = []
    for name in ("warp_dimage", "warp_dflow", "warp_dimage_dflow"):
        real = getattr(warp_vjp, name)
        monkeypatch.setattr(
            warp_vjp, name,
            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    x, flow, g = _inputs(rng, (1, 17, 23, 3))
    xt = _nchw(x)
    ft = torch.from_numpy(flow).requires_grad_(True)
    backward_warp_diff(xt, ft).backward(_nchw(g))
    assert calls == ["warp_dflow"] and xt.grad is None
    torch.testing.assert_close(
        ft.grad, warp_dflow_reference(_nchw(g), xt, ft.detach()),
        rtol=0, atol=0)
    xg = xt.detach().requires_grad_(True)
    backward_warp_diff(xg, ft.detach()).backward(_nchw(g))
    assert calls == ["warp_dflow", "warp_dimage"] and xg.grad is not None
    calls.clear()
    xg.grad = ft.grad = None
    backward_warp_diff(xg, ft).backward(_nchw(g))
    assert calls == ["warp_dimage_dflow"]
    torch.testing.assert_close(
        xg.grad, warp_dimage_reference(_nchw(g), ft.detach(), xg.dtype),
        rtol=0, atol=0)
    torch.testing.assert_close(
        ft.grad, warp_dflow_reference(_nchw(g), xt, ft.detach()),
        rtol=0, atol=0)


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


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_fused_adjoints_on_cpu_are_the_plain_pair(rng, x_dtype, flow_dtype,
                                                  layout):
    """On CPU tensors warp_dimage_dflow is (warp_dimage_reference,
    warp_dflow_reference) bit for bit, laid out as the kernel lays them
    out, and counts no launch."""
    x, flow, g = _inputs(rng, (2, 17, 23, 3))
    xt, gt = _nchw(x, x_dtype), _nchw(g, x_dtype)
    if layout == "nchw":
        xt, gt = xt.contiguous(), gt.contiguous()
    ft = torch.from_numpy(flow).to(flow_dtype)
    before = (warp_dimage.launches, warp_dimage.dflow_launches,
              warp_dflow.launches)
    dx, dflow = warp_dimage_dflow(gt, xt, ft)
    assert (warp_dimage.launches, warp_dimage.dflow_launches,
            warp_dflow.launches) == before
    want_dx = warp_dimage_reference(gt, ft, x_dtype)
    want_dflow = warp_dflow_reference(gt, xt, ft)
    assert dx.dtype == x_dtype and dx.stride() == gt.stride()
    assert dflow.dtype == flow_dtype and dflow.shape == (2, 17, 23, 2)
    assert torch.equal(dx, want_dx) and torch.equal(dflow, want_dflow)


def test_k4_plain_adds_channels_in_order(rng):
    """warp_dflow_reference adds each channel's fp32 term to a running sum
    from +0.0 in channel order, as the kernel does (numpy float32, one
    operation at a time), so the two round alike."""
    x, flow, g = _inputs(rng, (2, 17, 23, 5), scale=30.0)
    g[..., 1] *= 1e6  # terms of other sizes, so the order shows
    xt, gt, ft = _nchw(x), _nchw(g), torch.from_numpy(flow)
    y0, x0, y1, x1, wy, wx = (t.numpy() for t in
                              warp_cuda.bilinear_taps(ft, 17, 23))
    b = np.arange(2)[:, None, None]
    one = np.float32(1.0)
    jj = np.arange(23, dtype=np.float32)[None, None, :]
    ii = np.arange(17, dtype=np.float32)[None, :, None]
    m_x = (jj + flow[..., 0] >= 0).astype(np.float32)
    m_y = (ii + flow[..., 1] >= 0).astype(np.float32)
    dfx = np.zeros((2, 17, 23), np.float32)
    dfy = np.zeros((2, 17, 23), np.float32)
    for ch in range(5):
        a00, a01 = x[b, y0, x0, ch], x[b, y0, x1, ch]
        a10, a11 = x[b, y1, x0, ch], x[b, y1, x1, ch]
        tx = (one - wy) * (a01 - a00) + wy * (a11 - a10)
        ty = (one - wx) * (a10 - a00) + wx * (a11 - a01)
        dfx = dfx + (g[..., ch] * m_x) * tx
        dfy = dfy + (g[..., ch] * m_y) * ty
    got = warp_dflow_reference(gt, xt, ft).numpy()
    np.testing.assert_array_equal(got, np.stack([dfx, dfy], -1))


@pytest.mark.parametrize("fn", ["warp_rgb", "warp_dimage", "warp_dflow",
                                "warp_dimage_dflow"])
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
            "warp_dflow": lambda: warp_dflow(img, img, flow),
            "warp_dimage_dflow": lambda: warp_dimage_dflow(img, img, flow)}[fn]
    with pytest.raises(ValueError):
        call()


def test_kernel_sources_export_every_dtype_pair():
    """Every dtype combination the wrappers can ask for exists as a C entry
    point in the CUDA sources: K2 per (image, flow), K3 per (cotangent,
    flow, output), K4 alone and K3 with K4 per (image, flow)."""
    rgb = (kernel_build.CSRC_DIR / "warp_planes.cu").read_text()
    vjp = (kernel_build.CSRC_DIR / "warp_vjp.cu").read_text()
    tags = warp_cuda._DTYPE_TAG.values()
    for a in tags:
        for b in tags:
            assert f"TECOGAN_WARP_RGB_ENTRY(tecogan_warp_rgb_{a}_{b}," in rgb
            assert f"TECOGAN_DFLOW_ENTRY(tecogan_warp_dflow_{a}_{b}," in vjp
            assert (f"TECOGAN_DIMAGE_DFLOW_ENTRY(tecogan_warp_dimage_dflow_"
                    f"{a}_{b},") in vjp
            for o in tags:
                assert (f"TECOGAN_DIMAGE_ENTRY(tecogan_warp_dimage_{a}_{b}_"
                        f"{o},") in vjp


# each kernel's C launcher that reads the packed arguments: (source, name)
_LAUNCHERS = {"K1": ("warp_planes.cu", "launch_planes"),
              "K1 band": ("warp_planes.cu", "launch_planes"),
              "K2": ("warp_planes.cu", "launch_rgb"),
              "K3": ("warp_vjp.cu", "launch_dimage"),
              "K3+K4": ("warp_vjp.cu", "launch_dimage_dflow"),
              "K4": ("warp_vjp.cu", "launch_dflow"),
              "K5": ("warp_phases.cu", "launch_kernel")}


@pytest.mark.parametrize("kernel", sorted(_LAUNCHERS))
def test_wrappers_pack_what_the_c_launchers_read(monkeypatch, rng, kernel):
    """Each wrapper hands its C entry point one int64 array: the stream
    lands where the launcher reads it (``arg_ptr<CUstream_st>(a, k)``),
    and every ``strides_from(a + k)`` reads the element strides of the
    tensor it stands for. The wrappers run on CPU tensors with the device
    checks and the launch stubbed out; K1 and K5, which are operators whose
    CPU implementation is the plain version, through the CUDA
    implementation the dispatcher picks for CUDA tensors."""
    from tecogan_tpu_torch.ops import warp_phases as wp

    calls = []
    for mod in (warp_cuda, warp_vjp, wp):
        monkeypatch.setattr(mod, "launch",
                            lambda name, index, *a: calls.append(a))
    for mod in (warp_cuda, warp_vjp):
        monkeypatch.setattr(mod, "all_on_cpu", lambda *t: False)
    monkeypatch.setattr(warp_cuda, "cuda_index", lambda name, *t: 0)
    monkeypatch.setattr(wp, "cuda_index", lambda name, *t: 0)
    monkeypatch.setattr(warp_vjp, "_dimage_slots", lambda index: 7)

    x = torch.randn(2, 3, 8, 12)
    g = torch.randn(2, 3, 8, 12)
    flow = torch.randn(2, 2, 8, 12).permute(0, 2, 3, 1)  # an NCHW view
    sy = torch.rand(1, 4, 4, 6)
    sx = torch.rand(1, 4, 6, 4).transpose(2, 3)
    channels_last = x.contiguous(memory_format=torch.channels_last)
    run, strides = {
        "K1": (lambda: warp_cuda._warp_planes_cuda(x, flow), [flow]),
        "K1 band": (lambda: warp_cuda._warp_planes_cuda(x, flow, 4, 3),
                    [flow]),
        "K2": (lambda: warp_rgb(channels_last, flow),
               [channels_last, channels_last, flow]),
        "K3": (lambda: warp_dimage(channels_last, flow, torch.bfloat16),
               [channels_last, channels_last, flow]),
        "K3+K4": (lambda: warp_dimage_dflow(channels_last, x, flow),
                  [channels_last, channels_last, flow, x]),
        "K4": (lambda: warp_dflow(g, x, flow), [g, x, flow]),
        "K5": (lambda: wp._warp_phases_cuda(
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


def _float64_adjoint(g, flow):
    return warp_dimage_reference(g.double(), flow, torch.float64)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _SHAPES)
def test_k3_fixed_point_matches_float64_adjoint(rng, shape, g_dtype):
    """The fixed-point sums are within an fp32 rounding of the exact
    adjoint of the same fp32 products: rtol 1e-5, with an atol of 1e-6 *
    max |ref| for sums that cancel (the card's check is rtol 1e-4)."""
    _, flow, g = _inputs(rng, shape)
    gt, ft = _nchw(g, g_dtype), torch.from_numpy(flow)
    got = warp_dimage_reference(gt, ft, torch.float32)
    ref = _float64_adjoint(gt, ft)
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))
    # the mixed-precision call: the same sums rounded once more, to bf16
    torch.testing.assert_close(warp_dimage_reference(gt, ft, torch.bfloat16),
                               got.bfloat16(), rtol=0, atol=0)


@pytest.mark.parametrize("shape", _SHAPES[:2])
def test_k3_fixed_point_is_independent_of_order(rng, shape):
    """Any order of the scatter's terms (every output pixel's four taps with
    their products, as the card's atomics may add them) gives the same
    bits: the sums are integers."""
    _, flow, g = _inputs(rng, shape, scale=60.0)
    gt, ft = _nchw(g), torch.from_numpy(flow)
    n, c, h, w = gt.shape
    idx, prods = warp_vjp.dimage_terms(gt, ft)
    k = warp_vjp.dimage_scale(gt.abs().max(), h, w)
    want = warp_vjp.scatter_sums(idx, prods, h, w, k)
    torch.testing.assert_close(warp_dimage_reference(gt, ft, torch.float32),
                               want, rtol=0, atol=0)
    for seed in range(3):
        perm = torch.from_numpy(
            np.random.default_rng(seed).permutation(idx.shape[1]))
        got = warp_vjp.scatter_sums(idx[:, perm], prods[..., perm], h, w, k)
        assert torch.equal(got, want)


def test_k3_scale_keeps_every_sum_in_int64(rng):
    """2^k * M * H * W <= 2^62 for the exponent the kernel takes, so no
    source sum (at most M * H * W, the weights of a pixel summing to 1) can
    overflow; and the scale is not wasted by more than 2 bits."""
    for m in (1.0, 0.75, 3.0e38, 1e-30, 2.0 ** -149, 1e-40):
        for h, w in ((1, 1), (17, 23), (128, 128), (536, 1280)):
            k = warp_vjp.dimage_scale(torch.tensor(m, dtype=torch.float32),
                                      h, w)
            total = float(np.float32(m)) * h * w * 2.0 ** k
            assert 2.0 ** 60 <= total <= 2.0 ** 62


@pytest.mark.parametrize("case", ["zero", "tiny", "subnormal", "non-finite"])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_k3_edge_cases(rng, case, g_dtype):
    """M = 0 gives zeros; g of 1e-30 (products near the subnormal range)
    and of 1e-40 (a subnormal M, so a scale past fp32's range) keep their
    sums; one inf and one NaN in g give non-finite outputs exactly where a
    product is non-finite (a tap of weight 0 gets 0 * inf = NaN) and finite
    ones elsewhere."""
    _, flow, g = _inputs(rng, (1, 17, 23, 3))
    g = {"zero": 0.0 * g, "tiny": 1e-30 * g, "subnormal": 1e-40 * g,
         "non-finite": g}[case]
    gt, ft = _nchw(g, g_dtype), torch.from_numpy(flow)
    if case == "non-finite":
        gt = gt.clone()
        gt[0, 1, 3, 4] = float("inf")
        gt[0, 2, 10, 20] = float("nan")
    got = warp_dimage_reference(gt, ft, torch.float32)
    torch.testing.assert_close(warp_dimage(gt, ft, torch.float32), got,
                               rtol=0, atol=0, equal_nan=True)
    if case == "zero":
        assert torch.equal(got, torch.zeros_like(got))
    elif case == "non-finite":
        idx, prods = warp_vjp.dimage_terms(gt, ft)
        bad = warp_vjp.scatter_sums(idx, (~torch.isfinite(prods)).double(),
                                    17, 23, None) > 0
        assert bad.sum() >= 2
        assert torch.equal(~torch.isfinite(got), bad)
    else:
        ref = _float64_adjoint(gt, ft)
        assert float(got.abs().max()) > 0
        # as at unit scale, and fp32 products of 1e-40 keep a few bits: an
        # atol of some ulps of the smallest subnormal per term
        atol = max(1e-6 * float(ref.abs().max()), 64 * 2.0 ** -149)
        np.testing.assert_allclose(got.double().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=atol)


@pytest.mark.parametrize("shape", [(2, 128, 128), (18, 32, 32),
                                   (1, 536, 1280), (1, 17, 23)])
@pytest.mark.parametrize("cap", [1, 7, 128, 132 * 16])
def test_k3_stride_grid_takes_every_tile_once(shape, cap):
    """K3's cooperative grid has at most ``cap`` blocks, its grid-stride
    loops over (column tiles, row tiles, images) give every tile of
    ``tile_plan`` to exactly one block, and unless its rows reach the cap
    it has enough threads to convert every output element in one round of
    loads."""
    n, h, w = shape
    (tx, ty, tz), (lanes, warps) = warp_cuda.tile_plan(n, h, w, steps=1)
    gx, gy, gz = warp_cuda.stride_grid(n, 3, h, w, cap)
    blocks = gx * gy * gz
    assert 1 <= blocks <= cap
    if gy < cap // (gx * gz):
        assert (blocks * lanes * warps * warp_cuda.CONVERT_UNROLL
                >= n * 3 * h * w)
    hits = np.zeros((tx, ty, tz), np.int64)
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                hits[bx::gx, by::gy, bz::gz] += 1
    assert (hits == 1).all()


# K2's shapes: the training warps and the card check's shapes
@pytest.mark.parametrize("shape", [(2, 3, 128, 128), (18, 3, 32, 32),
                                   (1, 3, 17, 23), (2, 1, 5, 33)])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_k2_plan_writes_every_element_once(shape, layout):
    """K2's row tiles cover every output pixel once, and its strided
    stores (image base, then 32-bit channel, row and column offsets) put
    each (pixel, channel) at its own element of the output."""
    n, c, h, w = shape
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    out = torch.empty(shape).contiguous(memory_format=fmt)
    flow = torch.empty(n, 2, h, w).permute(0, 2, 3, 1)
    warp_cuda._rgb_plan(out.shape, out.stride(), out.stride(), flow.stride())
    b, i, j, _, _ = warp_cuda.tile_pixels(n, h, w)
    inside = (i < h) & (j < w)
    s0, s1, s2, s3 = out.stride()
    where = (b[inside] * s0 + i[inside] * s2 + j[inside] * s3)[:, None] \
        + np.arange(c)[None, :] * s1
    assert np.array_equal(np.sort(where.ravel()), np.arange(out.numel()))


@pytest.mark.parametrize("shape", [(2, 128, 128), (18, 32, 32),
                                   (1, 17, 23)])
def test_k4_plan_writes_every_element_once(shape):
    """K4's row tiles (K2's grid: column tiles, row tiles, images) cover
    every output pixel once, and its pair stores put each pixel's (dfx,
    dfy) at its own two elements of the dense (n, H, W, 2) output."""
    n, h, w = shape
    x = torch.empty(n, 3, h, w).contiguous(memory_format=torch.channels_last)
    flow = torch.empty(n, h, w, 2)
    warp_vjp._dflow_plan(x.shape, x.stride(), x.stride(), flow.stride())
    b, i, j, _, _ = warp_cuda.tile_pixels(n, h, w)
    inside = (i < h) & (j < w)
    pair = ((b[inside] * h + i[inside]) * w + j[inside]) * 2
    where = pair[:, None] + np.arange(2)[None, :]
    assert np.array_equal(np.sort(where.ravel()), np.arange(n * h * w * 2))


def test_k3_constants_match_the_cuda_source():
    text = (kernel_build.CSRC_DIR / "warp_vjp.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\w+);", text))
    assert int(consts["kUnroll"]) == warp_cuda.CONVERT_UNROLL
    # one pixel a lane: 32-column tiles of kTileRows rows
    assert "constexpr int kBlock = 32 * kTileRows;" in text
    assert "const int tiles_x = (W + 31) / 32;" in text


def test_k2_k3_plans_reject_offsets_past_32_bits():
    big = torch.Size((1, 3, 30000, 30000))
    strides = (2700000000, 1, 90000, 3)
    with pytest.raises(ValueError, match="32-bit"):
        warp_cuda._rgb_plan(big, strides, strides, (1, 60000, 2, 1))
    with pytest.raises(ValueError, match="32-bit"):
        warp_cuda.check_offsets("warp_dimage", big, (1, 60000, 2, 1),
                                strides, strides)
    # a flow row past 32 bits
    with pytest.raises(ValueError, match="32-bit"):
        warp_cuda.check_offsets("warp_dimage", torch.Size((1, 3, 8, 8)),
                                (1, 1, 2 ** 30, 1), (192, 64, 8, 1))


def test_k3_cpu_output_laid_out_as_the_kernels(rng):
    """warp_dimage returns torch.empty_like(g) in x_dtype: a channels_last
    cotangent gives a channels_last gradient, with the same values."""
    _, flow, g = _inputs(rng, (1, 17, 23, 3))
    gt, ft = _nchw(g), torch.from_numpy(flow)
    assert gt.is_contiguous(memory_format=torch.channels_last)
    got = warp_dimage(gt, ft, torch.bfloat16)
    assert got.stride() == torch.empty_like(gt).stride()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, warp_dimage(gt.contiguous(), ft, torch.bfloat16))
