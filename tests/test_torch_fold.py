"""Port parity for row-folded multi-stream inference
(``infer_sequence_batch(..., fold_streams=True)``): K1's band mode through
its plain version against the TPU kernel in interpret mode, the fold
helpers against the JAX package's, and the folded slice against the JAX
folded path and the port's own unfolded path (CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import frnet as jfrnet
from tecogan_tpu.models.networks import infer_sequence_batch as jinfer
from tecogan_tpu.models.networks import init_frnet
from tecogan_tpu.ops.warp_pallas import _warp_planes
from tecogan_tpu_torch.models.convert import state_dict_from_jax
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
from tecogan_tpu_torch.models.networks import frnet
from tecogan_tpu_torch.ops.warp_cuda import warp_planes, warp_planes_reference


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


# the folded HR geometry of 3 streams of 20x24 LR (the slice test's) at 4x
# and 2x, and of the H100 smoke run's 4 streams of 134 rows at 4x (cut to a
# 64-column strip)
_BANDS = [(3, 4, 20, 24), (3, 2, 20, 24), (4, 4, 134, 16)]


def _band_inputs(rng, streams, s, h, w, sigma, n=1, c=3):
    _, _, band = frnet._fold_geometry(s, h)
    hh, ww = streams * band, s * w
    planes = rng.standard_normal((n, c, hh, ww)).astype(np.float32)
    flow = (rng.standard_normal((n, hh, ww, 2)) * sigma).astype(np.float32)
    return planes, flow, band, s * h


@pytest.mark.parametrize("streams,s,h,w", _BANDS)
@pytest.mark.parametrize("sigma", [6.0, 30.0])
def test_band_reference_matches_pallas_interpret(rng, streams, s, h, w,
                                                 sigma):
    planes, flow, band, valid = _band_inputs(rng, streams, s, h, w, sigma)
    want = np.asarray(_warp_planes(jnp.asarray(planes), jnp.asarray(flow),
                                   interpret=True, band=band,
                                   band_valid=valid))
    got = warp_planes_reference(torch.from_numpy(planes),
                                torch.from_numpy(flow), band=band,
                                band_valid=valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_band_reference_bf16_matches_pallas_interpret(rng):
    planes, flow, band, valid = _band_inputs(rng, 3, 4, 20, 24, 30.0)
    pj = jnp.asarray(planes).astype(jnp.bfloat16)
    want = _warp_planes(pj, jnp.asarray(flow).astype(jnp.bfloat16),
                        interpret=True, band=band, band_valid=valid)
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    got = warp_planes_reference(torch.from_numpy(planes).bfloat16(),
                                torch.from_numpy(flow).bfloat16(), band=band,
                                band_valid=valid)
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got, want) <= 1


def test_band_mode_is_per_stream_warp(rng):
    """Each band warps like its own valid rows alone, whatever the other
    bands hold; band = 0 is the plain warp."""
    planes, flow, band, valid = _band_inputs(rng, 3, 2, 20, 24, 30.0)
    p, f = torch.from_numpy(planes), torch.from_numpy(flow)
    got = warp_planes(p, f, band=band, band_valid=valid)
    for b in range(3):
        rows = slice(b * band, b * band + valid)
        alone = warp_planes_reference(p[:, :, rows], f[:, rows])
        torch.testing.assert_close(got[:, :, rows], alone, rtol=0, atol=0)
    torch.testing.assert_close(warp_planes(p, f, band=0),
                               warp_planes_reference(p, f), rtol=0, atol=0)


@pytest.mark.parametrize("streams,band,valid", [(3, 34, 30), (4, 3, 2),
                                                (6, 1, 1)])
def test_band_mode_with_straddling_tiles_is_per_stream_warp(rng, streams,
                                                            band, valid):
    """The card checks' band geometries that the TPU kernel (32-row bands)
    cannot take and whose CUDA row tiles straddle two bands or hold
    several: the plain band mode still warps each band like its valid rows
    alone."""
    planes = rng.standard_normal((1, 3, streams * band, 40)).astype(
        np.float32)
    flow = (rng.standard_normal((1, streams * band, 40, 2)) * 6.0).astype(
        np.float32)
    p, f = torch.from_numpy(planes), torch.from_numpy(flow)
    got = warp_planes_reference(p, f, band=band, band_valid=valid)
    for b in range(streams):
        rows = slice(b * band, b * band + valid)
        alone = warp_planes_reference(p[:, :, rows], f[:, rows])
        torch.testing.assert_close(got[:, :, rows], alone, rtol=0, atol=0)


@pytest.mark.parametrize("band,valid", [(7, 3), (8, 0), (8, 9)])
def test_band_mode_rejects_bad_geometry(band, valid):
    planes = torch.zeros(1, 3, 16, 8)
    with pytest.raises(ValueError, match="band"):
        warp_planes(planes, torch.zeros(1, 16, 8, 2), band=band,
                    band_valid=valid)


@pytest.mark.parametrize("s", [4, 2])
@pytest.mark.parametrize("h", [20, 24, 134])
def test_fold_helpers_match_jax(s, h):
    n = 3
    g, ph, band = frnet._fold_geometry(s, h)
    assert (g, ph, band) == jfrnet._fold_geometry(s, h)
    got = frnet._fold_masks(s, n, h, ph, band)
    want = jfrnet._fold_masks(s, n, h, ph, band)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().ravel(),
                                      np.asarray(want[k]).ravel())
    for deg in ("BD", "BI"):
        np.testing.assert_array_equal(
            frnet._fold_residual_mh(FRNetConfig(scale=s, degradation=deg), n,
                                    h, ph),
            jfrnet._fold_residual_mh(JCfg(scale=s, degradation=deg), n, h,
                                     ph))


@pytest.mark.parametrize("scale", [4, 2])
def test_folded_slice_matches_jax_and_unfolded(rng, scale):
    """3 streams of 5 frames of 20x24 at chunk 3 (two chunks, one padded
    frame): the port's folded path against the JAX folded path (its banded
    warp in interpret mode) and against the port's unfolded path, in the
    band of tests/test_fast_path.py's folded-vs-unfolded test."""
    jcfg = JCfg(nf=8, nb=2, scale=scale, pallas_warp=False)
    params = jax.tree.map(np.asarray, init_frnet(jax.random.PRNGKey(5), jcfg))
    lr = rng.random((3, 5, 20, 24, 3)).astype(np.float32)
    want = np.asarray(jinfer(params, jnp.asarray(lr), jcfg, chunk=3,
                             fold_streams=True, _fold_interpret=True))

    cfg = FRNetConfig(nf=8, nb=2, scale=scale)
    net = FRNet.from_state_dict(cfg, state_dict_from_jax(params, 2, scale))
    before = warp_planes.launches
    got = infer_sequence_batch(net, torch.from_numpy(lr), cfg, chunk=3,
                               fold_streams=True).numpy()
    assert warp_planes.launches == before
    unfolded = infer_sequence_batch(net, torch.from_numpy(lr), cfg,
                                    chunk=3).numpy()
    assert got.shape == want.shape == (3, 5, 20 * scale, 24 * scale, 3)
    for ref in (want, unfolded):
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 1, diff.max()
        assert (diff > 0).mean() < 1e-3, (diff > 0).mean()


def test_fold_takes_precedence_over_packed16(rng, monkeypatch):
    cfg = FRNetConfig(nf=8, nb=1, scale=2)
    net = FRNet.random(cfg, torch.Generator().manual_seed(0))
    lr = torch.from_numpy(rng.random((2, 3, 16, 16, 3)).astype(np.float32))
    want = infer_sequence_batch(net, lr, cfg, chunk=2, fold_streams=True)

    def no_phases(*args):
        raise AssertionError("the packed16 recurrence ran")

    monkeypatch.setattr(frnet, "_chunk_phases", no_phases)
    p16 = FRNetConfig(nf=8, nb=1, scale=2, packed16=True)
    np.testing.assert_array_equal(
        infer_sequence_batch(net, lr, p16, chunk=2, fold_streams=True), want)
