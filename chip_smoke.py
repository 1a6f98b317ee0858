"""Smoke run of the PyTorch/CUDA port (tecogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles the CUDA kernels (nvcc, sm_90a) into build/kernels/;
3. K1 (the warp kernel) against its plain PyTorch version on the card, at
   the main path's shapes, the TPU kernel test's shapes and 1080p;
4. the main path: a VSRModel at the flagship width (nf=64, nb=10, 4x, BD,
   bf16) serves three requests, and the warp kernel must have been launched
   once per warped frame; then the FPS at bench.py's protocol and a
   torch.profiler breakdown of one such run;
5. the card against the CPU plain path on the same weights and inputs.

The last line is {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
NF, NB, SCALE = 64, 10, 4
# K1 tolerances: fp32 output within atol = rtol = 1e-5 of the plain
# version; bf16 output at most 1 bf16 ulp away (both round one fp32 value)
K1_F32_TOL = 1e-5
K1_BF16_ULPS = 1
# card vs CPU plain path bands (tests/test_golden.py's JAX fast-path bands)
F32_MAX_DIFF, F32_PSNR = 2, 54.0
BF16_MAX_DIFF, BF16_PSNR = 4, 48.0


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _require(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs

def _smooth_frames(rng, t, h, w):
    """(t, h, w, 3) float32 in [0, 1]: crops of a blurred random image that
    drift by a few pixels per frame, so the flow has work to do."""
    base = rng.random((h + 64, w + 64, 3)).astype(np.float32)
    for _ in range(3):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = (base - base.min()) / (base.max() - base.min())
    return np.stack([base[(2 * i) % 64:(2 * i) % 64 + h,
                          (3 * i) % 64:(3 * i) % 64 + w] for i in range(t)])


def _jax_layout_params(rng, nf, nb, scale, in_nc=3, out_nc=3):
    """A generator pytree in the JAX package's layout (conv HWIO, ConvT as
    the flipped HWIO kernel) with torch-default bounds U(+-1/sqrt(fan_in))."""
    def conv(cin, cout, fan_in=None):
        bound = 1.0 / math.sqrt(fan_in or 9 * cin)
        return {"w": rng.uniform(-bound, bound, (3, 3, cin, cout))
                .astype(np.float32),
                "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}

    fnet, cin = {}, 2 * in_nc
    for li, c in enumerate((32, 64, 128)):
        fnet[f"enc{li}_0"], fnet[f"enc{li}_1"] = conv(cin, c), conv(c, c)
        cin = c
    for li, c in enumerate((256, 128, 64)):
        fnet[f"dec{li}_0"], fnet[f"dec{li}_1"] = conv(cin, c), conv(c, c)
        cin = c
    fnet["flow_0"], fnet["flow_1"] = conv(cin, 32), conv(32, 2)
    srnet = {"conv_in": conv((scale * scale + 1) * in_nc, nf)}
    for bi in range(nb):
        srnet[f"res{bi}_0"], srnet[f"res{bi}_1"] = conv(nf, nf), conv(nf, nf)
    for ui in range(2 if scale == 4 else 1):
        srnet[f"up{ui}"] = conv(nf, nf, fan_in=9 * nf)  # torch: dim 1 = out
    srnet["conv_out"] = conv(nf, out_nc)
    return {"fnet": fnet, "srnet": srnet}


def _save_npz(tree, path):
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    walk(tree, "")
    np.savez(path, **flat)


# ------------------------------------------------------------------ phases

def _bf16_ulps(a, b) -> int:
    import torch

    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _cuda_ms(fn, iters):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_k1(card):
    """K1 against warp_planes_reference on the card. Returns (max abs err,
    {dtype: (kernel ms, plain ms)} at the main path's shape)."""
    import torch

    from tecogan_tpu_torch.ops.warp_cuda import (warp_planes,
                                                 warp_planes_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    cases = []
    for pd in dts:  # the main path's HR frame, every dtype and flow layout
        for fd in dts:
            for layout in ("nhwc", "nchw"):
                for sigma in (6.0, 30.0, 300.0):
                    cases.append(((1, 3, 536, 1280), pd, fd, layout, sigma))
    for shape in ((2, 3, 16, 130), (1, 1, 9, 257), (1, 3, 64, 128)):
        for pd in dts:
            for sigma in (6.0, 30.0, 300.0):
                cases.append((shape, pd, "f32", "nhwc", sigma))
    for pd in dts:
        cases.append(((1, 3, 1080, 1920), pd, pd, "nchw", 30.0))

    max_err = 0.0
    for shape, pd, fd, layout, sigma in cases:
        n, c, h, w = shape
        planes = torch.randn(shape, generator=gen, device=dev).to(dts[pd])
        flow = torch.randn((n, 2, h, w), generator=gen, device=dev) * sigma
        flow = flow.to(dts[fd])
        flow = (flow.permute(0, 2, 3, 1) if layout == "nchw"
                else flow.permute(0, 2, 3, 1).contiguous())
        torch.cuda.synchronize()
        got = warp_planes(planes, flow)
        torch.cuda.synchronize()
        ref = warp_planes_reference(planes, flow)
        _require(got.dtype == planes.dtype and got.shape == planes.shape,
                 f"K1 output {got.dtype} {tuple(got.shape)}")
        err = float((got.float() - ref.float()).abs().max())
        max_err = max(max_err, err)
        if pd == "f32":
            ok = torch.allclose(got, ref, rtol=K1_F32_TOL, atol=K1_F32_TOL)
            detail = f"max_abs_err={err:.3g}"
        else:
            ulps = _bf16_ulps(got, ref)
            ok = ulps <= K1_BF16_ULPS
            detail = f"max_abs_err={err:.3g} bf16_ulps={ulps}"
        print(f"K1 {shape} planes={pd} flow={fd}/{layout} sigma={sigma}: "
              f"{'ok' if ok else 'MISMATCH'} {detail}")
        _require(ok, f"K1 disagrees with its plain version at {shape} {pd}")

    timings = {}
    shape = (1, 3, 536, 1280)
    for pd in dts:
        planes = torch.randn(shape, generator=gen, device=dev).to(dts[pd])
        flow = (torch.randn((1, 2, 536, 1280), generator=gen, device=dev)
                * 6.0).to(dts[pd]).permute(0, 2, 3, 1)
        for _ in range(10):
            warp_planes(planes, flow)
            warp_planes_reference(planes, flow)
        k, p = [], []
        for _ in range(2):  # alternate: kernel, plain, kernel, plain
            k.append(_cuda_ms(lambda: warp_planes(planes, flow), 200))
            p.append(_cuda_ms(lambda: warp_planes_reference(planes, flow), 50))
        timings[pd] = (min(k), min(p))
        print(f"K1 time {shape} {pd} planes+flow (CUDA events): kernel "
              f"{min(k) * 1e3:.2f} us/call, plain {min(p) * 1e3:.2f} us/call "
              f"on {card}")
    return max_err, timings


def _test_opt(load_path):
    """experiments_BD/FRVSR/*/test.yml, in memory, on card 0, bf16."""
    return {
        "scale": SCALE, "manual_seed": SEED, "device_ids": [0],
        "dataset": {"degradation": {"type": "BD", "sigma": 1.5}},
        "model": {"name": "FRVSR", "generator": {
            "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": NF, "nb": NB,
            "compute_dtype": "bfloat16", "load_path": load_path}},
        "test": {"padding_mode": "reflect", "num_pad_front": 5},
    }


def _frames_warped(t, chunk):
    n_chunks = -(-t // chunk)
    return n_chunks * -(-t // n_chunks)


def phase_slice(ckpt, rng):
    """Three requests through VSRModel. Returns the kernel launch count."""
    import torch

    from tecogan_tpu_torch.models import VSRModel
    from tecogan_tpu_torch.ops.warp_cuda import warp_planes

    model = VSRModel(_test_opt(ckpt))
    requests = [
        {"lr": _smooth_frames(rng, 32, 134, 320)},
        {"lr": _smooth_frames(rng, 32, 134, 320)},
        {"gt": (_smooth_frames(rng, 32, 536, 1280) * 255).round()
         .astype(np.uint8)},
    ]
    n_pad = model.opt["test"]["num_pad_front"]
    expected = 0
    warp_planes.launches = 0
    for i, data in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr = model.prepare_inference_data(data)
        out = model.infer(lr)
        dt = time.perf_counter() - t0
        t = lr.shape[0]
        expected += _frames_warped(t + n_pad, 16)
        print(f"request {i} ({'gt' if 'gt' in data else 'lr'}): "
              f"{tuple(out.shape)} {out.dtype} in {dt:.3f} s (host clock, "
              f"first request includes warm-up)")
        _require(out.dtype == np.uint8 and out.shape == (t, 536, 1280, 3),
                 f"request {i}: {out.dtype} {out.shape}")
    launches = warp_planes.launches
    print(f"warp_planes launches in the main path: {launches}, frames "
          f"warped: {expected}")
    _require(launches == expected, "the main path did not launch K1 once "
             "per warped frame")
    return model, launches


def phase_fps(model, card):
    """bench.py's protocol: 64 frames of 134x320, bf16, chunk=64, one
    warm-up, min of 5, a checksum read back to force the sync."""
    import torch

    from tecogan_tpu_torch.models.networks import infer_sequence

    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    lr = torch.rand((64, 134, 320, 3), generator=gen, device=model.device)

    def run(x):
        return int(infer_sequence(model.net_g, x, model.cfg_g, chunk=64)
                   .sum(dtype=torch.int64).item())

    run(lr)
    times = []
    for rep in range(5):
        x = lr + (rep + 1) * 1e-6
        t0 = time.perf_counter()
        run(x)
        times.append(time.perf_counter() - t0)
    fps = 64 / min(times)
    print(f"FPS 64x134x320 4x BD nf=64 nb=10 bf16 chunk=64: {fps:.2f} "
          f"frames/s (min of 5: {min(times) * 1e3:.1f} ms) on {card}")
    return fps


def phase_profile(model, card):
    """One protocol run under torch.profiler: device busy share and kernel
    time by name. Informational — prints "not measured" if the profiler
    sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tecogan_tpu_torch.models.networks import infer_sequence

    lr = torch.rand((64, 134, 320, 3), device=model.device)
    infer_sequence(model.net_g, lr, model.cfg_g, chunk=64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer_sequence(model.net_g, lr, model.cfg_g, chunk=64)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's entry repeats
    # the time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print("profile: no device time recorded; busy share not measured")
        return
    print(f"profile (64 frames, under the profiler): wall {wall_us / 1e3:.1f} "
          f"ms, kernels {busy_us / 1e3:.1f} ms, device idle share "
          f"{1 - busy_us / wall_us:.3f} on {card}")
    top = sorted(rows, reverse=True)[:15]
    top += [r for r in rows if "warp_planes_kernel" in r[2] and r not in top]
    for t_us, count, key in top:
        print(f"  {t_us / 1e3:8.2f} ms {count:6d}x {t_us / count:8.2f} us  "
              f"{key[:100]}")


def phase_card_vs_cpu(sd, rng):
    import torch

    from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                   infer_sequence)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card vs CPU: TF32 off for cuDNN convolutions and matmuls")
    lr = torch.from_numpy(_smooth_frames(rng, 8, 64, 64))
    cfg32 = FRNetConfig(nf=NF, nb=NB, scale=SCALE)
    cfg16 = FRNetConfig(nf=NF, nb=NB, scale=SCALE, compute_dtype="bfloat16")
    cpu = infer_sequence(FRNet.from_state_dict(cfg32, sd, "cpu"), lr, cfg32,
                         chunk=4).numpy().astype(np.int32)
    net = FRNet.from_state_dict(cfg32, sd, "cuda")
    for cfg, max_diff, floor in ((cfg32, F32_MAX_DIFF, F32_PSNR),
                                 (cfg16, BF16_MAX_DIFF, BF16_PSNR)):
        got = infer_sequence(net, lr.cuda(), cfg, chunk=4).cpu().numpy()
        d = got.astype(np.int32) - cpu
        mse = float(np.mean(d.astype(np.float64) ** 2))
        psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
        ok = np.abs(d).max() <= max_diff and psnr > floor
        print(f"card {cfg.compute_dtype} vs CPU float32 (8x64x64, nf=64, "
              f"nb=10): max diff {np.abs(d).max()} (<= {max_diff}), PSNR "
              f"{psnr:.2f} dB (> {floor}): {'ok' if ok else 'FAIL'}")
        _require(ok, f"card {cfg.compute_dtype} output outside its band")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tecogan_tpu_torch import kernel_build
    from tecogan_tpu_torch.models.convert import state_dict_from_jax

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    path, secs, log = kernel_build.build()
    print(f"nvcc build for sm_90a: {path.name} in {secs:.2f} s")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "error")):
            print(f"  ptxas: {line.strip()}")

    max_err, timings = phase_k1(card)

    rng = np.random.default_rng(SEED)
    params = _jax_layout_params(rng, NF, NB, SCALE)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "G_random.npz")
        _save_npz(params, ckpt)
        model, launches = phase_slice(ckpt, rng)
    phase_fps(model, card)
    phase_profile(model, card)
    del model
    phase_card_vs_cpu(state_dict_from_jax(params, NB, SCALE), rng)

    _require("jax" not in sys.modules, "jax was imported")
    ms, plain_ms = timings["bf16"]
    print(json.dumps({"kernels": [{
        "name": "warp_planes", "route": "cuda",
        "source": "tecogan_tpu_torch/csrc/warp_planes.cu",
        "replaces": "tecogan_tpu/ops/warp_pallas.py:153",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
