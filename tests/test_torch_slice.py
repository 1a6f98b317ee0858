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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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
    # nor does row-sharded inference
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VSRModel({**opt, "test": {**opt["test"], "spatial_partition": True}})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vsr_model_infer_numerics(monkeypatch, rng, dtype):
    """VSRModel.infer runs a float32 generator with TF32 off and cuDNN's
    deterministic algorithms, and a bf16 one under the settings as they
    are; either way the settings are restored after the call."""
    from tecogan_tpu_torch.models import vsr_model

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32

    seen = []

    def recording(*args, **kwargs):
        seen.append(flags())
        return infer_sequence(*args, **kwargs)

    monkeypatch.setattr(vsr_model, "infer_sequence", recording)
    opt = _test_opt(None)
    opt["model"]["generator"]["compute_dtype"] = dtype
    model = VSRModel(opt)
    saved = flags()
    try:
        cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = (
            False, True, True)
        model.infer(rng.random((4, 8, 8, 3)).astype(np.float32))
        assert seen == [(True, False, False) if dtype == "float32"
                        else (False, True, True)]
        assert flags() == (False, True, True)
    finally:
        cudnn.deterministic, cudnn.allow_tf32, matmul.allow_tf32 = saved


def test_port_imports_without_jax():
    """Every tecogan_tpu_torch module imports with jax, the JAX package,
    cv2 and yaml blocked; a CPU infer_sequence, a CPU FRVSR training step
    and a CPU TecoGAN step launch no kernel; a serving artifact exports,
    loads and serves PNG frames, profile mode runs and LPIPS scores."""
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
        from tecogan_tpu_torch.models.networks import infer_sequence_batch
        from tecogan_tpu_torch.ops.warp_phases import warp_phases
        p16 = FRNetConfig(nf=8, nb=1, packed16=True)
        out = infer_sequence(net, torch.rand(2, 16, 16, 3), p16, chunk=2)
        assert out.shape == (2, 64, 64, 3) and out.dtype == torch.uint8
        out = infer_sequence_batch(net, torch.rand(3, 2, 12, 16, 3), cfg,
                                   chunk=2, fold_streams=True)
        assert out.shape == (3, 2, 48, 64, 3) and out.dtype == torch.uint8
        assert warp_planes.launches == 0, warp_planes.launches
        assert warp_phases.launches == 0, warp_phases.launches
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
        from tecogan_tpu_torch.models.networks import (VGG19, DTrunk,
                                                       STNetConfig)
        cfg_d = STNetConfig(spatial_size=32)
        net_d = DTrunk.random(cfg_d, torch.Generator().manual_seed(1))
        opt_d, sched_d = schedules.make_adam({"lr": 1e-4},
                                             net_d.parameters())
        state = steps.tecogan_init_state(net, net_d, opt, opt_d)
        gan = tcfg._replace(
            tempo_extent=2, crop_border_ratio=0.75,
            feature_crit={"type": "CosineSimilarity"}, pingpong_crit=cb,
            gan_crit={"type": "GAN", "weight": 0.01})
        state, logs = steps.tecogan_train_step(
            state, {"gt": gt}, cfg_g=cfg, cfg_d=cfg_d, tcfg=gan,
            sched_g=sched, sched_d=sched_d,
            vgg=VGG19.random(torch.Generator().manual_seed(2)))
        assert set(logs) == set(steps.TECOGAN_LOG_KEYS)
        assert all(bool(torch.isfinite(v)) for v in logs.values())
        assert (warp_rgb.launches, warp_dimage.launches,
                warp_dflow.launches) == (0, 0, 0)
        import os, tempfile
        import numpy as np
        from tecogan_tpu_torch import serve, serving
        from tecogan_tpu_torch.main import main
        from tecogan_tpu_torch.metrics.lpips import LPIPS, AlexNetFeatures
        from tecogan_tpu_torch.utils.png import write_png
        tmp = tempfile.mkdtemp()
        sd = net.state_dict()
        serving.save_artifact(f"{tmp}/m.tecosrv", serving.export_stream(
            sd, cfg, 1, 3, 16, 16, chunk=2, platforms=["cpu"]),
            {"n": 1, "t": 3, "h": 16, "w": 16, "scale": 4, "nb": 1},
            params=sd)
        os.makedirs(f"{tmp}/in/s")
        for i in range(3):
            write_png(f"{tmp}/in/s/{i}.png",
                      np.full((16, 16, 3), 40 * i, np.uint8))
        assert serve.main([f"{tmp}/m.tecosrv", f"{tmp}/in", f"{tmp}/out",
                           "--quiet"]) == {"s": 3}
        assert sorted(os.listdir(f"{tmp}/out/s")) == ["0.png", "1.png",
                                                      "2.png"]
        with open(f"{tmp}/train.yml", "w") as f:
            f.write("scale: 4\\ndataset:\\n  degradation:\\n    type: BD\\n"
                    "model:\\n  name: FRVSR\\n  generator:\\n    name: FRNet\\n"
                    "    in_nc: 3\\n    out_nc: 3\\n    nf: 8\\n    nb: 1\\n")
        prof = main(["--exp_dir", tmp, "--mode", "profile", "--opt",
                     f"{tmp}/train.yml", "--gpu_ids", "-1", "--lr_size",
                     "3x16x16"])
        assert prof["gflops"] > 0 and prof["counted_gflops"] > 0
        torch.save(AlexNetFeatures().state_dict(), f"{tmp}/alexnet.pth")
        torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1)
                    for i, c in enumerate((64, 192, 384, 256, 256))},
                   f"{tmp}/alex.pth")
        d = LPIPS("alex", f"{tmp}/alexnet.pth", f"{tmp}/alex.pth",
                  device="cpu")(np.zeros((48, 48, 3), np.uint8),
                                np.full((48, 48, 3), 90, np.uint8))
        assert d.shape == (1,) and np.isfinite(d).all()
        assert warp_planes.launches == 0, warp_planes.launches
        print(len(mods), "modules")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 18


def test_bf16_long_sequence_drift_bound(rng):
    """tests/test_golden.py's bound on bf16 recurrence drift, for the
    port: over a 96-frame clip the bf16 path stays above 45 dB PSNR of the
    fp32 path on every frame, and the last 16 frames are not more than
    6 dB below the first 16 (the HR carry does not compound error)."""
    t, h, w = 96, 32, 48
    base = rng.random((h * 2, w * 2, 3)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    lr = torch.from_numpy(np.stack(
        [base[(i % 28):(i % 28) + h, (i % 44):(i % 44) + w]
         for i in range(t)]))
    _, net = _port_net(3, 16, 2, 4)
    a = infer_sequence(net, lr, FRNetConfig(nf=16, nb=2, scale=4),
                       chunk=16).numpy().astype(np.float64)
    b = infer_sequence(net, lr, FRNetConfig(nf=16, nb=2, scale=4,
                                            compute_dtype="bfloat16"),
                       chunk=16).numpy().astype(np.float64)
    mse = np.mean((a - b) ** 2, axis=(1, 2, 3))
    psnr = 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))
    assert psnr.min() > 45.0, psnr.min()
    first, last = psnr[:16].mean(), psnr[-16:].mean()
    assert last > first - 6.0, (first, last)


def test_test_mode_runs_without_jax_cv2_or_yaml(tmp_path):
    """`python -m tecogan_tpu_torch.main --mode test --gpu_ids -1` with
    jax, the JAX package, cv2 and yaml blocked: 8-bit PNG folders in
    (``utils/png.py::read_image`` imports cv2 only for other frames), PNGs
    and a metrics JSON with PSNR and SSIM out, the tOF and LPIPS gates
    logged."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "tecogan_tpu", "cv2", "yaml"):
            sys.modules[name] = None
        import json, os
        import numpy as np, torch
        from tecogan_tpu_torch.main import main
        from tecogan_tpu_torch.models.convert import jax_from_state_dict
        from tecogan_tpu_torch.models.networks import FRNet, FRNetConfig
        from tecogan_tpu_torch.utils.ckpt import save_pytree
        from tecogan_tpu_torch.utils.png import read_png, write_png
        root = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        for i in range(4):
            os.makedirs(f"{{root}}/GT/clip", exist_ok=True)
            write_png(f"{{root}}/GT/clip/f{{i:02d}}.png",
                      (rng.random((32, 40, 3)) * 255).astype(np.uint8))
        net = FRNet.random(FRNetConfig(nf=8, nb=2),
                           torch.Generator().manual_seed(0))
        save_pytree(jax_from_state_dict(net.state_dict(), 2, 4),
                    f"{{root}}/G_iter7.npz")
        with open(f"{{root}}/test.yml", "w") as f:
            f.write(f'''# test mode, written as text
        scale: 4
        manual_seed: 0
        dataset:
          degradation:
            type: BD
            sigma: 1.5
          test1:
            name: Toy
            gt_seq_dir: {{root}}/GT
            lr_seq_dir: ~
        model:
          name: FRVSR
          generator:
            name: FRNet
            in_nc: 3
            out_nc: 3
            nf: 8
            nb: 2
            load_path: {{root}}/G_iter7.npz
        test:
          save_res: true
          res_dir: null
          save_json: true
          json_dir: null
          padding_mode: reflect
          num_pad_front: 2
        metric:
          PSNR:
            colorspace: y
          SSIM:
          tOF:
            colorspace: y
          LPIPS:
            net: alex
            version: 0.1
        ''')
        main(["--exp_dir", root, "--mode", "test", "--opt",
              f"{{root}}/test.yml", "--gpu_ids", "-1"])
        with open(f"{{root}}/test/metrics/Toy_avg.json") as f:
            d = json.load(f)
        assert list(d) == ["G_iter7"], d
        assert list(d["G_iter7"]) == ["PSNR", "SSIM"], d
        assert all(np.isfinite(float(v)) for v in d["G_iter7"].values())
        out = f"{{root}}/test/results/Toy/G_iter7/clip"
        assert sorted(os.listdir(out)) == [f"f{{i:02d}}.png"
                                           for i in range(4)]
        assert read_png(f"{{out}}/f00.png").shape == (32, 40, 3)
        for name in ("jax", "tecogan_tpu", "cv2", "yaml"):
            assert sys.modules[name] is None, name
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok"]
    warnings = [line for line in res.stderr.splitlines()
                if "[WARNING]" in line]
    assert len(warnings) == 2, warnings
    assert "LPIPS disabled" in warnings[0]
    assert "tOF disabled" in warnings[1] and "cv2" in warnings[1]


def test_train_mode_runs_without_jax_cv2_or_yaml(tmp_path):
    """`python -m tecogan_tpu_torch.main --mode train --gpu_ids -1` with
    jax, the JAX package, cv2 and yaml blocked: a records store written by
    the port in, 2 logged iterations, a checkpoint and a validation entry
    out."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "tecogan_tpu", "cv2", "yaml"):
            sys.modules[name] = None
        import json, logging, os
        import numpy as np
        import torch
        torch.set_num_threads(1)  # tiny steps; the suite runs in parallel
        from tecogan_tpu_torch.data.records import RecordWriter
        from tecogan_tpu_torch.main import main
        from tecogan_tpu_torch.utils.logging_utils import setup_logger
        from tecogan_tpu_torch.utils.png import write_png
        root = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        w = RecordWriter(f"{{root}}/GT.rec")
        for vid in ("v0", "v1"):
            w.add_sequence(vid, (rng.random((3, 48, 48, 3)) * 255
                                 ).astype(np.uint8))
        w.close()
        os.makedirs(f"{{root}}/Val/clip")
        for i in range(3):
            write_png(f"{{root}}/Val/clip/f{{i}}.png",
                      (rng.random((32, 40, 3)) * 255).astype(np.uint8))
        with open(f"{{root}}/train.yml", "w") as f:
            f.write(f'''# train mode, written as text
        scale: 4
        manual_seed: 0
        dataset:
          degradation:
            type: BD
            sigma: 1.5
          train:
            name: Toy
            seq_dir: {{root}}/GT.rec
            crop_size: 32
            batch_size_per_gpu: 2
            num_worker_per_gpu: 2
          test:
            name: Val
            gt_seq_dir: {{root}}/Val
        model:
          name: FRVSR
          generator:
            name: FRNet
            in_nc: 3
            out_nc: 3
            nf: 8
            nb: 2
        train:
          tempo_extent: 3
          total_iter: 2
          moving_first_frame: true
          moving_factor: 0.7
          generator:
            lr: 1.0e-4
          pixel_crit:
            type: CB
            weight: 1
            reduction: mean
          warping_crit:
            type: CB
            weight: 1
            reduction: mean
        test:
          test_freq: 2
          save_res: false
          save_json: true
          padding_mode: reflect
          num_pad_front: 1
        metric:
          PSNR:
            colorspace: y
        logger:
          log_freq: 1
          decay: 0.99
          ckpt_freq: 2
        ''')
        lines = []
        handler = logging.Handler()
        handler.emit = lambda r: lines.append(r.getMessage())
        setup_logger("base").addHandler(handler)
        model = main(["--exp_dir", f"{{root}}/exp", "--mode", "train",
                      "--opt", f"{{root}}/train.yml", "--gpu_ids", "-1"])
        assert model.state["step"] == 2
        logged = [m for m in lines if m.startswith("[epoch: 0 | iter: ")]
        assert len(logged) == 2 and "lr_G: 1.00e-04] l_pix_G: " in logged[1]
        assert sorted(os.listdir(f"{{root}}/exp/train/ckpt")) == [
            "G_iter2.npz", "state_iter2.pth"]
        with open(f"{{root}}/exp/test/metrics/Val_avg.json") as f:
            assert list(json.load(f)) == ["G_iter2"]
        for name in ("jax", "tecogan_tpu", "cv2", "yaml"):
            assert sys.modules[name] is None, name
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["ok"]
