"""Port parity for the packed16 streaming recurrence
(``FRNetConfig(packed16=True)``): the per-phase coordinates against the
JAX package's ``_phase_flow_coords``, SRNet on a packed HR input, and the
slice against the JAX packed16 path (its phase-plane warp in interpret
mode) on the CPU."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tecogan_tpu.ops.warp_pallas as jwarp
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import frnet as jfrnet
from tecogan_tpu.models.networks import infer_sequence_batch as jinfer
from tecogan_tpu.models.networks import init_frnet
from tecogan_tpu_torch.models.convert import state_dict_from_jax
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
from tecogan_tpu_torch.models.networks import frnet
from tecogan_tpu_torch.ops.spatial import space_to_depth
from tecogan_tpu_torch.ops.warp_phases import warp_phases

# LR frames of one 32x128 tile: the TPU kernel in interpret mode enumerates
# the displacements of each (32, 128) tile, and a plane padded up to a tile
# (e.g. 16x24) edge-pads its coordinates into displacements of ~190 x 70
# HR pixels, about 50 s per call; a whole tile takes about 5 s
_T, _H, _W = 4, 32, 128


@pytest.mark.parametrize("scale,degradation", [(4, "BD"), (2, "BD"),
                                               (4, "BI")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase_flow_coords_match_jax(rng, scale, degradation, dtype):
    """f32 coordinates from an fp32 or bf16 LR flow; 20x28 LR, whose
    16x24 flow is reflect-padded first."""
    flow = (rng.standard_normal((2, 16, 24, 2)) * 8).astype(np.float32)
    jflow = jnp.asarray(flow).astype(dtype)
    tflow = torch.from_numpy(flow).to(getattr(torch, dtype))
    want = jfrnet._phase_flow_coords(
        JCfg(scale=scale, degradation=degradation), jflow, 20, 28)
    got = frnet._phase_flow_coords(
        FRNetConfig(scale=scale, degradation=degradation),
        tflow.permute(0, 3, 1, 2), 20, 28)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert g.shape == w.shape == (2, scale * scale, 20, 28)
        # two fp32 matrix products summed in another order: a few ulps of
        # coordinates up to 112
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=3e-5)


def test_srnet_forward_packed_is_forward(rng):
    cfg = FRNetConfig(nf=8, nb=2, scale=4)
    net = FRNet.random(cfg, torch.Generator().manual_seed(3))
    lr = torch.from_numpy(rng.random((2, 3, 8, 12)).astype(np.float32))
    hr = torch.from_numpy(rng.random((2, 3, 32, 48)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(
            net.srnet.forward_packed(lr, space_to_depth(hr, 4)),
            net.srnet(lr, hr), rtol=0, atol=0)


@pytest.fixture(scope="module")
def p16_case():
    """The JAX packed16 path, fp32 and bf16, on one set of weights and LR
    frames; _sr_step_p16 imports the phase-plane warp at call time, so an
    interpret-mode wrapper stands in for the TPU kernel."""
    params = jax.tree.map(np.asarray, init_frnet(
        jax.random.PRNGKey(21), JCfg(nf=8, nb=2, scale=4)))
    lr = np.random.default_rng(4).random((1, _T, _H, _W, 3)).astype(
        np.float32)
    orig = jwarp.backward_warp_packed_planes
    jwarp.backward_warp_packed_planes = functools.partial(orig,
                                                          interpret=True)
    try:
        want = {dt: np.asarray(jinfer(
            params, jnp.asarray(lr),
            JCfg(nf=8, nb=2, scale=4, packed16=True, platform="tpu",
                 compute_dtype=dt), chunk=2))
            for dt in ("float32", "bfloat16")}
    finally:
        jwarp.backward_warp_packed_planes = orig
    return params, lr, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed16_slice_matches_jax(p16_case, dtype):
    """4 frames at chunk 2 (the LR-prev carry crosses a chunk): the port's
    packed16 path within 1 gray level of the JAX packed16 path, and the
    fp32 paths agree on nearly every pixel; no kernel launches on the
    CPU."""
    params, lr, want = p16_case
    cfg = FRNetConfig(nf=8, nb=2, scale=4, compute_dtype=dtype,
                      packed16=True)
    net = FRNet.from_state_dict(cfg, state_dict_from_jax(params, 2, 4))
    before = warp_phases.launches
    got = infer_sequence_batch(net, torch.from_numpy(lr), cfg,
                               chunk=2).numpy()
    assert warp_phases.launches == before
    assert got.shape == want[dtype].shape == (1, _T, 4 * _H, 4 * _W, 3)
    diff = np.abs(got.astype(np.int32) - want[dtype].astype(np.int32))
    assert diff.max() <= 1, diff.max()
    if dtype == "float32":
        assert (diff > 0).mean() < 1e-4, (diff > 0).mean()


def test_packed16_matches_default_path(rng):
    """The two recurrences differ only in the warp's input: f32 per-phase
    coordinates against the HR flow, which is f32 too in fp32 mode."""
    cfg = FRNetConfig(nf=8, nb=2, scale=2)
    net = FRNet.random(cfg, torch.Generator().manual_seed(5))
    lr = torch.from_numpy(rng.random((2, 3, 16, 20, 3)).astype(np.float32))
    p16 = infer_sequence_batch(
        net, lr, FRNetConfig(nf=8, nb=2, scale=2, packed16=True), chunk=2)
    ref = infer_sequence_batch(net, lr, cfg, chunk=2)
    diff = (p16.int() - ref.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
