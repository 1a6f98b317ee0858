"""Port parity for the phase-plane warp (K5): ``warp_phases_reference`` —
the plain version the CUDA kernel is held against on the card — against
the TPU kernel ``backward_warp_packed_planes`` in interpret mode and
against the HR-frame warp followed by space_to_depth, the wrapper's
dispatch rules on the CPU, and the kernel's launch plan."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tecogan_tpu.ops.warp_pallas import backward_warp_packed_planes
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.ops import warp_cuda
from tecogan_tpu_torch.ops.spatial import space_to_depth
from tecogan_tpu_torch.ops.warp_cuda import warp_planes_reference
from tecogan_tpu_torch.ops.warp_phases import (HALO_BOUND, KERNEL_SCALES,
                                               _phases_plan, phase_planes,
                                               warp_phases,
                                               warp_phases_reference)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# tests/test_warp_pallas.py's packed-planes cases: (s, h, w, sigma, clip)
_CASES = [
    (4, 32, 128, 11.0, None),
    (2, 24, 256, 11.0, None),
    (4, 16, 128, 150.0, 170.0),  # near the halo bound, heavy border clamping
]


def _phase_coords(flow, s):
    """(n, H, W, 2) HR flow -> clamped absolute per-phase coordinates
    (n, s*s, h, w) x 2 (tests/test_warp_pallas.py's helper)."""
    n, hh, ww, _ = flow.shape
    h, w = hh // s, ww // s
    sy = np.empty((n, s * s, h, w), np.float32)
    sx = np.empty((n, s * s, h, w), np.float32)
    ii = np.arange(h)[:, None]
    jj = np.arange(w)[None, :]
    for py in range(s):
        for px in range(s):
            f = flow[:, py::s, px::s, :]
            sy[:, py * s + px] = np.clip(s * ii + py + f[..., 1], 0, hh - 1)
            sx[:, py * s + px] = np.clip(s * jj + px + f[..., 0], 0, ww - 1)
    return sy, sx


def _inputs(rng, s, h, w, sigma, clip, n=1, c=3):
    """An HR frame (n, c, s*h, s*w), its flow, its (n, s*s, c, h, w) phase
    planes and the per-phase coordinates."""
    hr = rng.standard_normal((n, c, s * h, s * w)).astype(np.float32)
    flow = rng.standard_normal((n, s * h, s * w, 2)) * sigma
    if clip is not None:
        flow = np.clip(flow, -clip, clip)
    flow = flow.astype(np.float32)
    planes = hr.reshape(n, c, h, s, w, s).transpose(0, 3, 5, 1, 2, 4)
    planes = np.ascontiguousarray(planes.reshape(n, s * s, c, h, w))
    sy, sx = _phase_coords(flow, s)
    return hr, flow, planes, sy, sx


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,h,w,sigma,clip", _CASES)
def test_reference_matches_pallas_interpret(rng, s, h, w, sigma, clip):
    _, _, planes, sy, sx = _inputs(rng, s, h, w, sigma, clip)
    want = np.asarray(backward_warp_packed_planes(
        jnp.asarray(planes), jnp.asarray(sy), jnp.asarray(sx), s,
        interpret=True))
    got = warp_phases_reference(*_t(planes, sy, sx), s)
    assert got.shape == want.shape == (1, 3, s * s, h, w)
    # the JAX test's tolerance; measured max |diff| 2.4e-7 at every case
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,h,w,sigma,clip", _CASES)
def test_reference_matches_hr_warp_then_space_to_depth(rng, s, h, w, sigma,
                                                       clip):
    """K5 on the phase planes == K1's plain version on the HR frame, then
    space_to_depth; the planes may be the (n, s*s, c, h, w) tensor or the
    strided phase-plane view of the HR frame, with identical results, and
    the result's transpose(1, 2) is conv_in's space_to_depth order."""
    hr, flow, planes, sy, sx = _inputs(rng, s, h, w, sigma, clip, n=2)
    hr, flow, planes, sy, sx = _t(hr, flow, planes, sy, sx)
    want = space_to_depth(warp_planes_reference(hr, flow), s)
    got = warp_phases_reference(planes, sy, sx, s)
    view = warp_phases_reference(phase_planes(hr, s), sy, sx, s)
    torch.testing.assert_close(view, got, rtol=0, atol=0)
    packed = got.transpose(1, 2)
    assert packed.is_contiguous()
    torch.testing.assert_close(packed.flatten(1, 2), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("s,h,w,c", [(4, 13, 33, 3), (2, 9, 45, 2),
                                     (4, 5, 20, 1)])
def test_reference_matches_pallas_interpret_ragged_tiles(rng, s, h, w, c):
    """The card checks' extra K5 shapes: widths off the CUDA kernel's
    column tile, heights off its 4-row tile, and 1 or 2 channels (its
    channel loop)."""
    _, _, planes, sy, sx = _inputs(rng, s, h, w, 3.0, None, c=c)
    want = np.asarray(backward_warp_packed_planes(
        jnp.asarray(planes), jnp.asarray(sy), jnp.asarray(sx), s,
        interpret=True))
    got = warp_phases_reference(*_t(planes, sy, sx), s)
    assert got.shape == want.shape == (1, c, s * s, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_phase_planes_is_the_frame_viewed_by_phase(rng):
    """phase_planes (one as_strided view) holds HR pixel (s*i + py,
    s*j + px) at (py, px, i, j), for a contiguous frame and for a strided,
    offset one, without a copy."""
    big = torch.from_numpy(rng.standard_normal((2, 4, 20, 36)).astype(
        np.float32))
    for hr in (big[:, :3, :16, :32].contiguous(), big[:, 1:, 2:18, 3:35]):
        for s in (2, 4):
            n, c, hh, ww = hr.shape
            want = hr.reshape(n, c, hh // s, s, ww // s, s).permute(
                0, 3, 5, 1, 2, 4)
            got = phase_planes(hr, s)
            assert got.data_ptr() == hr.data_ptr()
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="phase planes"):
        phase_planes(torch.zeros(1, 3, 10, 16), 4)


def _k5_pixels(n, s, h, w):
    """Every output (b, q, i, j) of K5's launch, by its index formulas
    (csrc/warp_phases.cu: blockIdx.z = b*s + py, lane l takes px = l mod s
    and column l div s), with each lane's HR column."""
    b_img, i, col, lane, _ = warp_cuda.tile_pixels(n * s, h, w,
                                                   lanes_per_col=s)
    px = lane % s
    return b_img // s, (b_img % s) * s + px, i, col, s * col + px


_PLAN_CASES = [(1, 4, 134, 320), (1, 2, 134, 320), (1, 4, 32, 128),
               (1, 2, 24, 256), (1, 4, 13, 33), (2, 2, 9, 45)]


@pytest.mark.parametrize("n,s,h,w", _PLAN_CASES)
def test_tile_plan_covers_every_output_once(n, s, h, w):
    """K5's grid and index formulas write every (b, q, i, j) exactly once,
    a warp's lanes take 32 neighbouring HR columns of one HR row (the s px
    phases of 32/s output columns), and the path's 32-bit offsets fit."""
    b, q, i, j, hr_col = _k5_pixels(n, s, h, w)
    inside = (i < h) & (j < w)
    hits = np.zeros((n, s * s, h, w), np.int64)
    np.add.at(hits, (b[inside], q[inside], i[inside], j[inside]), 1)
    assert (hits == 1).all()
    assert (i == i[..., :1, :]).all() and (q // s == q[..., :1, :] // s).all()
    lane = np.arange(32).reshape(1, 1, 1, 1, 32, 1)
    assert (hr_col - hr_col[..., :1, :] == lane).all()


@pytest.mark.parametrize("layout", ["view", "copy"])
def test_launch_arguments_and_output_layout(rng, layout):
    """The plan hands the kernel the planes' six (n, py, px, c, i, j)
    strides, for the phase-plane view and the (n, s*s, c, h, w) copy
    alike, and allocates the output with the plain version's size and
    strides."""
    s, h, w = 4, 6, 20
    hr, _, planes, sy, sx = _t(*_inputs(rng, s, h, w, 3.0, None))
    p = phase_planes(hr, s) if layout == "view" else planes
    args, size, stride = _phases_plan(s, p.shape, p.stride(), sy.shape,
                                      sy.stride(), sx.shape, sx.stride())
    six = phase_planes(hr, s).stride() if layout == "view" else (
        planes.unflatten(1, (s, s)).stride())
    assert args == (1, s, 3, h, w, *six, *sy.stride(), *sx.stride())
    ref = warp_phases_reference(p, sy, sx, s)
    assert (size, stride) == (tuple(ref.shape), ref.stride())


def test_tile_plan_rejects_what_the_kernel_cannot_index():
    shape = torch.Size((1, 4, 4, 3, 134, 320))
    coords = torch.Size((1, 16, 134, 320))
    rows = (1, 1, 1, 1)
    with pytest.raises(ValueError, match="32-bit"):
        _phases_plan(4, shape, (0, 1, 1, 2 ** 30, 1, 1), coords, rows,
                     coords, rows)
    with pytest.raises(ValueError, match="grid"):
        _phases_plan(4, torch.Size((20000, 4, 4, 3, 8, 8)),
                     (1, 1, 1, 1, 1, 1), torch.Size((20000, 16, 8, 8)), rows,
                     torch.Size((20000, 16, 8, 8)), rows)
    with pytest.raises(ValueError, match="scales"):
        _phases_plan(3, torch.Size((1, 9, 3, 8, 8)), (1, 1, 1, 1, 1),
                     torch.Size((1, 9, 8, 8)), rows, torch.Size((1, 9, 8, 8)),
                     rows)
    with pytest.raises(ValueError, match="coordinates"):
        _phases_plan(4, shape, (1, 1, 1, 1, 1, 1), coords, rows,
                     torch.Size((1, 16, 134, 321)), rows)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def test_reference_bf16_matches_pallas_interpret(rng):
    """bf16 planes: fp32 taps and one rounding to bf16, as the TPU kernel
    (which accumulates into an f32 output and casts once)."""
    _, _, planes, sy, sx = _inputs(rng, 2, 24, 256, 11.0, None)
    pj = jnp.asarray(planes).astype(jnp.bfloat16)
    want = backward_warp_packed_planes(pj, jnp.asarray(sy), jnp.asarray(sx),
                                       2, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    sy_t, sx_t = _t(sy, sx)
    got = warp_phases_reference(torch.from_numpy(planes).bfloat16(), sy_t,
                                sx_t, 2)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= 1


def test_halo_clamp_and_zero_taps(rng):
    """Coordinates beyond s*46 HR pixels of their cell are clamped to the
    bound (the TPU kernel's safety net), and taps outside the HR frame
    read 0 (its zero halo)."""
    s, h, w = 4, 4, 128
    _, _, planes, sy, sx = _inputs(rng, s, h, w, 3.0, None)
    planes, sy, sx = _t(planes, sy, sx)
    col = (s * torch.arange(w)).float()[None, :]
    bound = float(s * HALO_BOUND)
    far = warp_phases_reference(planes, sy,
                                (col + bound + 300.0).expand_as(sx), s)
    at_bound = warp_phases_reference(planes, sy,
                                     (col + bound).expand_as(sx), s)
    torch.testing.assert_close(far, at_bound, rtol=0, atol=0)
    assert far[..., 0].abs().max() > 0  # column 184 lies inside the frame

    # half a pixel above the frame: the y0 = -1 taps read 0
    zero_y = torch.full_like(sy, -0.5)
    got = warp_phases_reference(planes, zero_y, sx, s)
    top = warp_phases_reference(planes, torch.zeros_like(sy), sx, s)
    torch.testing.assert_close(got, 0.5 * top, rtol=1e-6, atol=1e-6)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing(rng):
    _, _, planes, sy, sx = _inputs(rng, 2, 8, 16, 3.0, None)
    args = _t(planes, sy, sx)
    before = warp_phases.launches
    torch.testing.assert_close(warp_phases(*args, 2),
                               warp_phases_reference(*args, 2), rtol=0,
                               atol=0)
    assert warp_phases.launches == before


@pytest.mark.parametrize("planes_dev,coords_dev", [("meta", "meta"),
                                                   ("cpu", "meta"),
                                                   ("meta", "cpu")])
def test_non_cpu_non_cuda_tensors_raise(planes_dev, coords_dev):
    planes = torch.empty(1, 4, 3, 8, 8, device=planes_dev)
    sy = torch.empty(1, 4, 8, 8, device=coords_dev)
    with pytest.raises(ValueError):
        warp_phases(planes, sy, sy, 2)


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="planes"):
        warp_phases_reference(torch.zeros(1, 9, 3, 4, 4),
                              torch.zeros(1, 4, 4, 4),
                              torch.zeros(1, 4, 4, 4), 2)
    with pytest.raises(ValueError, match="coordinates"):
        warp_phases_reference(torch.zeros(1, 4, 3, 4, 4),
                              torch.zeros(1, 4, 4, 5),
                              torch.zeros(1, 4, 4, 4), 2)


def test_kernel_source_exports_every_dtype():
    text = (kernel_build.CSRC_DIR / "warp_phases.cu").read_text()
    for tag in warp_cuda._DTYPE_TAG.values():
        assert f"TECOGAN_PHASES_ENTRY(tecogan_warp_phases_{tag}," in text


def test_kernel_source_builds_every_scale_the_wrapper_takes():
    """Both C entry points dispatch every scale in KERNEL_SCALES to its
    template instance, and nothing else."""
    text = (kernel_build.CSRC_DIR / "warp_phases.cu").read_text()
    cases = re.findall(r"case (\d+):\s+return launch_scale<TI, (\d+)>", text)
    assert sorted((int(a), int(b)) for a, b in cases) == [
        (s, s) for s in KERNEL_SCALES]
    assert "default:\n      return (int)cudaErrorInvalidValue;" in text
