"""Port parity for the warp (K1): ``warp_planes_reference`` — the plain
version the CUDA kernel is held against on the card — against the TPU
kernel in interpret mode and the gather warp, the wrapper's dispatch rules
on the CPU, and the kernel's launch plan (``tile_plan``) at the paths' and
the card checks' shapes."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tecogan_tpu.ops import backward_warp
from tecogan_tpu.ops.warp_pallas import _warp_planes
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.ops import warp_cuda
from tecogan_tpu_torch.ops.warp_cuda import warp_planes, warp_planes_reference

# the shapes of tests/test_warp_pallas.py, as (n, c, h, w), and ragged
# tiles of the CUDA kernel (a width off its 64-column tile and its 32-lane
# warp, heights off its 4-row tile, one channel)
_CASES = [
    ((1, 3, 24, 40), 6.0),
    ((2, 3, 16, 130), 30.0),
    ((1, 1, 9, 257), 300.0),
    ((1, 3, 64, 128), 80.0),
    ((1, 3, 13, 200), 30.0),
    ((2, 1, 5, 33), 30.0),
]


def _inputs(rng, shape, maxflow):
    n, c, h, w = shape
    planes = rng.standard_normal(shape).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * maxflow).astype(np.float32)
    return planes, flow


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("shape,maxflow", _CASES)
def test_reference_matches_pallas_interpret(rng, shape, maxflow):
    planes, flow = _inputs(rng, shape, maxflow)
    want = np.asarray(_warp_planes(jnp.asarray(planes), jnp.asarray(flow),
                                   interpret=True))
    got = warp_planes_reference(torch.from_numpy(planes),
                                torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,maxflow", _CASES)
def test_reference_matches_gather_warp(rng, shape, maxflow):
    planes, flow = _inputs(rng, shape, maxflow)
    want = np.asarray(backward_warp(jnp.asarray(planes.transpose(0, 2, 3, 1)),
                                    jnp.asarray(flow)))
    got = warp_planes_reference(torch.from_numpy(planes),
                                torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=1e-5,
                               atol=1e-5)


def test_reference_zero_flow_identity(rng):
    planes = torch.from_numpy(
        rng.standard_normal((1, 3, 16, 128)).astype(np.float32))
    flow = torch.zeros(1, 16, 128, 2)
    torch.testing.assert_close(warp_planes_reference(planes, flow), planes,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("flow_bf16", [False, True])
def test_reference_bf16_matches_pallas_interpret(rng, flow_bf16):
    """bf16 planes (and optionally a bf16 flow, read as fp32 in the kernel):
    fp32 taps and one rounding to bf16, as the TPU kernel does."""
    planes, flow = _inputs(rng, (2, 3, 16, 130), 30.0)
    pj = jnp.asarray(planes).astype(jnp.bfloat16)
    fj = jnp.asarray(flow)
    pt = torch.from_numpy(planes).bfloat16()
    ft = torch.from_numpy(flow)
    if flow_bf16:
        fj = fj.astype(jnp.bfloat16)
        ft = ft.bfloat16()
    want = _warp_planes(pj, fj, interpret=True)
    assert want.dtype == jnp.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    got = warp_planes_reference(pt, ft)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= 1


def test_reference_takes_strided_nchw_flow(rng):
    planes, flow = _inputs(rng, (2, 3, 16, 130), 30.0)
    flow_nchw = torch.from_numpy(np.ascontiguousarray(flow.transpose(0, 3, 1, 2)))
    view = flow_nchw.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    p = torch.from_numpy(planes)
    torch.testing.assert_close(warp_planes(p, view),
                               warp_planes(p, torch.from_numpy(flow)),
                               rtol=0, atol=0)


def test_cpu_dispatch_uses_plain_version_and_counts_nothing(rng):
    planes, flow = _inputs(rng, (1, 3, 24, 40), 6.0)
    before = warp_planes.launches
    got = warp_planes(torch.from_numpy(planes), torch.from_numpy(flow))
    want = warp_planes_reference(torch.from_numpy(planes),
                                 torch.from_numpy(flow))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert warp_planes.launches == before


@pytest.mark.parametrize("planes_dev,flow_dev", [("meta", "meta"),
                                                 ("cpu", "meta"),
                                                 ("meta", "cpu")])
def test_non_cpu_non_cuda_tensors_raise(planes_dev, flow_dev):
    """Only CPU tensors take the plain version; everything else must go
    to the kernel or raise — there is no fallback."""
    planes = torch.empty(1, 3, 8, 8, device=planes_dev)
    flow = torch.empty(1, 8, 8, 2, device=flow_dev)
    with pytest.raises(ValueError):
        warp_planes(planes, flow)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(kernel_build.BuildError, match="nvcc not found"):
        kernel_build.build()
    assert not (tmp_path / "kernels").exists() or not any(
        (tmp_path / "kernels").iterdir())


def test_library_path_tracks_sources(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one")
    monkeypatch.setattr(kernel_build, "CSRC_DIR", src)
    p1 = kernel_build.library_path()
    (src / "a.cu").write_text("// two")
    p2 = kernel_build.library_path()
    assert p1 != p2 and p1.parent == p2.parent == kernel_build.BUILD_DIR


def test_kernel_source_exports_every_dtype_pair():
    """Every (planes, flow) dtype pair the wrapper can ask for exists as a
    C entry point in the CUDA source."""
    text = (kernel_build.CSRC_DIR / "warp_planes.cu").read_text()
    for a in warp_cuda._DTYPE_TAG.values():
        for b in warp_cuda._DTYPE_TAG.values():
            assert f"TECOGAN_WARP_ENTRY(tecogan_warp_planes_{a}_{b}," in text


# K1's shapes: the main path's frame, 4 folded streams, the card checks'
# shapes (1080p, ragged tiles)
_PLAN_SHAPES = [(1, 3, 536, 1280), (1, 3, 2176, 1280), (1, 3, 1080, 1920),
                (2, 3, 16, 130), (1, 1, 9, 257), (2, 1, 5, 33)]


@pytest.mark.parametrize("shape", _PLAN_SHAPES)
def test_tile_plan_covers_every_pixel_once(shape):
    """K1's grid and index formulas write every output pixel exactly once,
    a warp's lanes take 32 neighbouring columns of one row, and every
    offset the kernel keeps in 32 bits fits."""
    n, c, h, w = shape
    assert warp_cuda.tile_plan(n, h, w)[1] == (32, warp_cuda.TILE_ROWS)
    b, i, j, lane, _ = warp_cuda.tile_pixels(n, h, w)
    inside = (i < h) & (j < w)
    hits = np.zeros((n, h, w), np.int64)
    np.add.at(hits, (b[inside], i[inside], j[inside]), 1)
    assert (hits == 1).all()
    # lanes of one warp step: one row, columns j0 .. j0 + 31
    assert (i == i[..., :1, :]).all()
    assert (j - j[..., :1, :] == lane - lane[..., :1, :]).all()
    # the paths' flow: the (n, H, W, 2) view of an NCHW tensor
    warp_cuda._planes_plan(torch.Size(shape), torch.Size((n, h, w, 2)),
                           (2 * h * w, w, 1, h * w), 0, 0)


def test_tile_plan_rejects_what_the_kernel_cannot_index():
    with pytest.raises(ValueError, match="grid"):
        warp_cuda.tile_plan(70000, 8, 8)
    with pytest.raises(ValueError, match="grid"):
        warp_cuda.tile_plan(1, 600000, 8)
    with pytest.raises(ValueError, match="32-bit"):
        warp_cuda._planes_plan(torch.Size((1, 3, 30000, 30000)),
                               torch.Size((1, 30000, 30000, 2)),
                               (1800000000, 60000, 2, 1), 0, 0)
    with pytest.raises(ValueError, match="band"):
        warp_cuda._planes_plan(torch.Size((1, 3, 16, 8)),
                               torch.Size((1, 16, 8, 2)), (256, 16, 2, 1), 7,
                               3)


@pytest.mark.parametrize("h,band,valid", [(2176, 544, 536), (864, 288, 268),
                                          (102, 34, 30), (12, 3, 2),
                                          (6, 1, 1)])
def test_band_row_from_tile_first_row(h, band, valid):
    """Band mode takes row i's place in its band from its block's first row
    (one remainder) and its offset in the block, subtracting band while the
    block straddles bands; that is i mod band for every row."""
    _, i, j, _, by = warp_cuda.tile_pixels(1, h, 64)
    row = (by * warp_cuda.TILE_ROWS) % band + (i - by * warp_cuda.TILE_ROWS)
    while (row >= band).any():
        row = np.where(row >= band, row - band, row)
    inside = i < h
    np.testing.assert_array_equal(row[inside], i[inside] % band)
    assert valid <= band


def test_tile_constants_match_the_cuda_source():
    """The plan's constants are the kernels' (csrc/warp_common.cuh), and
    the kernels use no shared memory, so no launch needs more than the
    default 48 KB or a cudaFuncSetAttribute call."""
    text = (kernel_build.CSRC_DIR / "warp_common.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kTileRows"]) == warp_cuda.TILE_ROWS
    assert int(consts["kTileSteps"]) == warp_cuda.TILE_STEPS
    for src in ("warp_planes.cu", "warp_phases.cu", "warp_common.cuh"):
        assert "__shared__" not in (kernel_build.CSRC_DIR / src).read_text()
