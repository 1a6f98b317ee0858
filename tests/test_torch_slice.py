"""Port parity for the whole slice: tecogan_tpu_torch's streaming
``infer_sequence`` and ``VSRModel`` test mode against the committed golden
corpora and against the JAX package run on the same weights (CPU)."""

import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import infer_sequence as jinfer
from tecogan_tpu.models.networks import init_frnet
from tecogan_tpu.models.vsr_model import VSRModel as JVSRModel
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch.models import VSRModel
from tecogan_tpu_torch.models.convert import state_dict_from_jax
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence)

_GOLDEN = osp.join(osp.dirname(osp.abspath(__file__)), "golden")
_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _port_net(key, nf, nb, scale):
    params = init_frnet(jax.random.PRNGKey(key),
                        JCfg(nf=nf, nb=nb, scale=scale, pallas_warp=False))
    params = jax.tree.map(np.asarray, params)
    cfg = FRNetConfig(nf=nf, nb=nb, scale=scale)
    return params, FRNet.from_state_dict(
        cfg, state_dict_from_jax(params, nb, scale))


def _diff_psnr(out, ref):
    d = out.astype(np.int32) - ref.astype(np.int32)
    mse = np.mean(d.astype(np.float64) ** 2)
    return np.abs(d), 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


@pytest.fixture(scope="module")
def golden():
    return np.load(osp.join(_GOLDEN, "frvsr_4x_bd.npz"))


@pytest.fixture(scope="module")
def golden_net():
    return _port_net(7, 32, 4, 4)[1]


@pytest.mark.parametrize("si", [0, 1])
def test_fp32_matches_golden(golden, golden_net, si):
    cfg = FRNetConfig(nf=32, nb=4, scale=4)
    out = infer_sequence(golden_net, torch.from_numpy(golden[f"lr_{si}"]),
                         cfg, chunk=4).numpy()
    assert out.dtype == np.uint8 and out.shape == golden[f"out_{si}"].shape
    diff, psnr = _diff_psnr(out, golden[f"out_{si}"])
    assert diff.max() <= 3, diff.max()
    assert psnr > 54.0, psnr


def test_bf16_matches_golden(golden, golden_net):
    cfg = FRNetConfig(nf=32, nb=4, scale=4, compute_dtype="bfloat16")
    out = infer_sequence(golden_net, torch.from_numpy(golden["lr_0"]), cfg,
                         chunk=4).numpy()
    diff, psnr = _diff_psnr(out, golden["out_0"])
    assert diff.max() <= 4, diff.max()
    assert (diff > 2).mean() < 1e-4
    assert psnr > 48.0, psnr
    # the caller's fp32 module is not cast in place
    assert next(golden_net.parameters()).dtype == torch.float32


@pytest.mark.parametrize("scale", [4, 2])
def test_flagship_fp32_matches_golden(scale):
    flagship = np.load(osp.join(_GOLDEN, "frvsr_flagship.npz"))
    _, net = _port_net(13, 64, 10, scale)
    cfg = FRNetConfig(nf=64, nb=10, scale=scale)
    out = infer_sequence(net, torch.from_numpy(flagship[f"lr_x{scale}"]),
                         cfg, chunk=4).numpy()
    diff, psnr = _diff_psnr(out, flagship[f"out_x{scale}"])
    assert diff.max() <= 3, diff.max()
    assert psnr > 54.0, psnr


def test_chunking_padding_and_carries_match_jax(rng):
    """t=7 at chunk=3: balanced chunks of 3 with 2 edge-padded frames,
    LR-prev carried across chunks, zero carries at frame 0, an LR size
    FNet floors (20x28 -> 16x24 flow, reflect-padded back)."""
    params, net = _port_net(11, 16, 2, 4)
    lr = rng.random((7, 20, 28, 3)).astype(np.float32)
    jcfg = JCfg(nf=16, nb=2, scale=4, pallas_warp=False)
    want = np.asarray(jinfer(params, jnp.asarray(lr), jcfg, chunk=3))
    got = infer_sequence(net, torch.from_numpy(lr),
                         FRNetConfig(nf=16, nb=2, scale=4), chunk=3).numpy()
    assert got.shape == want.shape == (7, 80, 112, 3)
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    # a state dict works in place of a module
    got_sd = infer_sequence(net.state_dict(), torch.from_numpy(lr),
                            FRNetConfig(nf=16, nb=2, scale=4), chunk=3)
    np.testing.assert_array_equal(got_sd.numpy(), got)


def _test_opt(load_path, mode="reflect"):
    return {
        "scale": 4, "manual_seed": 0, "device_ids": [],
        "dataset": {"degradation": {"type": "BD", "sigma": 1.5}},
        "model": {"name": "FRVSR", "generator": {
            "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 16, "nb": 2,
            "load_path": load_path}},
        "test": {"padding_mode": mode, "num_pad_front": 2},
    }


@pytest.mark.parametrize("mode", ["reflect", "replicate"])
def test_vsr_model_bd_from_gt_matches_jax(tmp_path, rng, mode):
    """Test mode end to end: BD from uint8 GT, front padding, infer, trim —
    both models load one .npz checkpoint."""
    params, _ = _port_net(17, 16, 2, 4)
    ckpt = str(tmp_path / "G.npz")
    jckpt.save_pytree(params, ckpt)
    opt = _test_opt(ckpt, mode)
    gt = (rng.random((5, 64, 88, 3)) * 255).astype(np.uint8)

    jm = JVSRModel(opt)
    jlr = jm.prepare_inference_data({"gt": gt})
    want = jm.infer(jlr)

    tm = VSRModel(opt)
    assert tm.device == torch.device("cpu")
    tlr = tm.prepare_inference_data({"gt": gt})
    np.testing.assert_allclose(tlr.numpy(), jlr, atol=1e-6)
    padded, n_pad = tm.pad_sequence(torch.from_numpy(np.array(jlr)))
    jpadded, jn_pad = jm.pad_sequence(jlr)
    assert n_pad == jn_pad == 2
    np.testing.assert_array_equal(padded.numpy(), jpadded)
    got = tm.infer(tlr)
    assert got.dtype == np.uint8 and got.shape == want.shape == (5, 64, 88, 3)
    assert np.abs(got.astype(np.int32) - want).max() <= 1


def test_vsr_model_requires_cuda_or_explicit_cpu():
    opt = _test_opt(None)
    del opt["device_ids"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VSRModel(opt)
    # training is ported, and likewise never falls back to the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VSRModel({**opt, "is_train": True})
    with pytest.raises(NotImplementedError):
        VSRModel({**_test_opt(None), "test": {"spatial_partition": True}})


def test_port_imports_without_jax():
    """Every tecogan_tpu_torch module imports with jax, the JAX package,
    cv2 and yaml blocked; a CPU infer_sequence and a CPU training step
    launch no kernel."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "tecogan_tpu", "cv2", "yaml"):
            sys.modules[name] = None
        import torch
        import tecogan_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            tecogan_tpu_torch.__path__, "tecogan_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        from tecogan_tpu_torch.models.networks import (
            FRNet, FRNetConfig, infer_sequence)
        from tecogan_tpu_torch.ops.warp_cuda import warp_planes
        cfg = FRNetConfig(nf=8, nb=1)
        net = FRNet.random(cfg, torch.Generator().manual_seed(0))
        out = infer_sequence(net, torch.rand(2, 16, 16, 3), cfg, chunk=2)
        assert out.shape == (2, 64, 64, 3) and out.dtype == torch.uint8
        assert warp_planes.launches == 0, warp_planes.launches
        from tecogan_tpu_torch.models import schedules, steps
        from tecogan_tpu_torch.ops.warp_cuda import warp_rgb
        from tecogan_tpu_torch.ops.warp_vjp import warp_dflow, warp_dimage
        cb = {"type": "CB"}
        tcfg = steps.TrainConfig(scale=4, degradation="BD", sigma=1.5,
                                 pixel_crit=cb, warping_crit=cb,
                                 mixed_precision=True)
        opt, sched = schedules.make_adam({"lr": 1e-4}, net.parameters())
        state = steps.frvsr_init_state(net, opt)
        gt = torch.randint(0, 256, (1, 2, 40, 40, 3), dtype=torch.uint8)
        state, logs = steps.frvsr_train_step(state, {"gt": gt}, cfg_g=cfg,
                                             tcfg=tcfg, sched_g=sched)
        assert state["step"] == 1 and set(logs) == {"l_pix_G", "l_warp_G"}
        assert (warp_rgb.launches, warp_dimage.launches,
                warp_dflow.launches) == (0, 0, 0)
        print(len(mods), "modules")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 18
