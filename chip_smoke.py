"""Smoke run of the PyTorch/CUDA port (tecogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles the CUDA kernels (one nvcc per source, sm_90a) into
   build/kernels/;
3. K1 (the inference warp kernel) against its plain PyTorch version on the
   card, at the main path's shapes, the TPU kernel test's shapes and 1080p;
4. the inference path: a VSRModel at the flagship width (nf=64, nb=10, 4x,
   BD, bf16) serves three requests, and K1 must have been launched once
   per warped frame; then the FPS at bench.py's protocol and a
   torch.profiler breakdown of one such run;
5. inference on the card against the CPU plain path, same weights and
   inputs;
6. K2, K3 and K4 (the training warp and its two adjoints) against their
   plain versions at the training shapes and the TPU kernel test's shapes,
   image and flow in f32 and bf16, NCHW and channels_last, with their
   times;
7. the training path: a VSRModel built like the Vimeo FRVSR train.yml
   (nf=64, nb=10, 4x BD, batch 2 x 10 frames of 136^2 uint8 GT, bf16 mixed
   precision, remat) takes five steps; the K2/K3/K4 launch counts must be
   exactly what the step's structure gives; ms/step, a profile of one step,
   then save and resume into a fresh model;
8. one training step on the card against the CPU, fp32 and bf16.

The second-to-last line lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Imports no JAX.
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


# K2 is held to K1's tolerances (same arithmetic, same rounding). K4 sums
# three channels in fp32 in the kernel's order: rtol 1e-5, with an atol of
# 1e-5 * max|ref| for terms that cancel; a bf16 flow gradient rounds two
# such fp32 values, so it may differ by one bf16 ulp (2^-7 relative). K3
# adds fp32 atomics in an order that changes from run to run; against a
# float64 plain version: rtol 1e-4, with an atol of 1e-5 * max|ref|.
K4_RTOL, K4_ATOL_REL, K4_BF16_RTOL = 1e-5, 1e-5, 2.0 ** -7
K3_RTOL, K3_ATOL_REL = 1e-4, 1e-5
# the two training warps at full width: HR (batch 2, 128^2 GT crop) and the
# warping loss's LR warp (2 x 9 frame pairs of 32^2)
TRAIN_WARP_SHAPES = ((2, 3, 128, 128), (18, 3, 32, 32))
# tests/test_warp_vjp.py's shapes, as (n, c, h, w)
VJP_TEST_SHAPES = ((2, 3, 32, 48), (1, 3, 17, 23), (2, 3, 40, 128),
                   (1, 3, 64, 128))


def _vjp_flow(gen, dev, n, h, w, sigma):
    """Random flow with tests/test_warp_vjp.py's border flows (two corners
    far out of range) and, for 32-aligned heights, its roll-alias rows."""
    import torch

    flow = torch.randn((n, h, w, 2), generator=gen, device=dev) * sigma
    flow[:, :3, :3] = 25.0
    flow[:, -2:, -2:] = -30.0
    if h % 32 == 0:
        flow[:, h - 32:h - 28, :, 1] = float(h)
    return flow


def phase_k234(card):
    """K2, K3 and K4 against their plain versions on the card. Returns
    {kernel: (max abs err, kernel ms, plain ms)}, the times at the HR
    training warp in bf16."""
    import torch

    from tecogan_tpu_torch.ops.warp_cuda import warp_planes_reference, warp_rgb
    from tecogan_tpu_torch.ops.warp_vjp import (warp_dflow,
                                                warp_dflow_reference,
                                                warp_dimage,
                                                warp_dimage_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    err = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    k3_spread = 0.0
    n_cases = 0
    for shape in TRAIN_WARP_SHAPES + VJP_TEST_SHAPES:
        n, c, h, w = shape
        for sigma in (6.0, 30.0, 300.0):
            for xd in dts:
                for fd in dts:
                    for layout in ("nchw", "channels_last"):
                        fmt = (torch.channels_last if layout == "channels_last"
                               else torch.contiguous_format)
                        x = torch.rand(shape, generator=gen, device=dev).to(
                            dts[xd]).contiguous(memory_format=fmt)
                        g = torch.randn(shape, generator=gen, device=dev).to(
                            dts[xd]).contiguous(memory_format=fmt)
                        flow = _vjp_flow(gen, dev, n, h, w, sigma).to(dts[fd])
                        tag = f"{shape} x={xd}/{layout} flow={fd} sigma={sigma}"
                        torch.cuda.synchronize()

                        # K2
                        got = warp_rgb(x, flow)
                        torch.cuda.synchronize()
                        ref = warp_planes_reference(x, flow)
                        _require(got.dtype == x.dtype and got.shape == x.shape
                                 and got.stride() == x.stride(),
                                 f"K2 output {got.dtype} {got.stride()} {tag}")
                        e = float((got.float() - ref.float()).abs().max())
                        err["K2"] = max(err["K2"], e)
                        ok = (torch.allclose(got, ref, rtol=K1_F32_TOL,
                                             atol=K1_F32_TOL) if xd == "f32"
                              else _bf16_ulps(got, ref) <= K1_BF16_ULPS)
                        _require(ok, f"K2 disagrees with its plain version: "
                                 f"{tag} max_abs_err={e:.3g}")

                        # K3, in fp32 (the cast to the image dtype is plain
                        # torch), twice for the run-to-run spread
                        a = warp_dimage(g, flow, torch.float32)
                        b = warp_dimage(g, flow, torch.float32)
                        torch.cuda.synchronize()
                        ref = warp_dimage_reference(g.double(), flow,
                                                    torch.float64)
                        atol = K3_ATOL_REL * float(ref.abs().max())
                        e = float((a.double() - ref).abs().max())
                        err["K3"] = max(err["K3"], e)
                        k3_spread = max(k3_spread, float((a - b).abs().max()))
                        _require(torch.allclose(a.double(), ref, rtol=K3_RTOL,
                                                atol=atol),
                                 f"K3 disagrees with its float64 plain "
                                 f"version: {tag} max_abs_err={e:.3g}")

                        # K4
                        got = warp_dflow(g, x, flow)
                        torch.cuda.synchronize()
                        ref = warp_dflow_reference(g, x, flow)
                        _require(got.dtype == flow.dtype
                                 and got.shape == (n, h, w, 2),
                                 f"K4 output {got.dtype} {tuple(got.shape)}")
                        atol = K4_ATOL_REL * float(ref.float().abs().max())
                        rtol = K4_RTOL if fd == "f32" else K4_BF16_RTOL
                        e = float((got.float() - ref.float()).abs().max())
                        err["K4"] = max(err["K4"], e)
                        _require(torch.allclose(got.float(), ref.float(),
                                                rtol=rtol, atol=atol),
                                 f"K4 disagrees with its plain version: "
                                 f"{tag} max_abs_err={e:.3g}")
                        n_cases += 1
    print(f"K2/K3/K4 against their plain versions: {n_cases} cases ok "
          f"(shapes {TRAIN_WARP_SHAPES + VJP_TEST_SHAPES}, sigma 6/30/300, "
          f"image and flow f32/bf16, NCHW and channels_last); max abs err "
          f"K2 {err['K2']:.3g}, K3 (vs float64) {err['K3']:.3g}, K4 "
          f"{err['K4']:.3g}")
    print(f"K3 run-to-run max difference over two launches (fp32 atomics): "
          f"{k3_spread:.3g}")

    out = {}
    for shape in TRAIN_WARP_SHAPES:
        n, c, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev).bfloat16()
        g = torch.randn(shape, generator=gen, device=dev).bfloat16()
        flow = (torch.randn((n, h, w, 2), generator=gen, device=dev)
                * 6.0).bfloat16()
        pairs = {
            "K2": (lambda: warp_rgb(x, flow),
                   lambda: warp_planes_reference(x, flow)),
            "K3": (lambda: warp_dimage(g, flow, torch.bfloat16),
                   lambda: warp_dimage_reference(g, flow, torch.bfloat16)),
            "K4": (lambda: warp_dflow(g, x, flow),
                   lambda: warp_dflow_reference(g, x, flow)),
        }
        for name, (kern, plain) in pairs.items():
            for _ in range(10):
                kern()
                plain()
            k, p = [], []
            for _ in range(2):  # alternate: kernel, plain, kernel, plain
                k.append(_cuda_ms(kern, 200))
                p.append(_cuda_ms(plain, 50))
            print(f"{name} time {shape} bf16 image+flow (CUDA events): "
                  f"kernel {min(k) * 1e3:.2f} us/call, plain "
                  f"{min(p) * 1e3:.2f} us/call on {card}")
            if shape == TRAIN_WARP_SHAPES[0]:
                out[name] = (err[name], min(k), min(p))
    return out


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


def _profile(fn, label, card, keep):
    """Run fn once under torch.profiler and print the device busy share and
    kernel time by name (the 15 largest, plus every kernel whose name
    contains one of ``keep``). Informational: prints "not measured" if the
    profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): a CPU op's entry repeats
    # the time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy_us = sum(r[0] for r in rows)
    if not busy_us:
        print(f"profile ({label}): no device time recorded; busy share not "
              f"measured")
        return
    print(f"profile ({label}, under the profiler): wall {wall_us / 1e3:.1f} "
          f"ms, kernels {busy_us / 1e3:.1f} ms in "
          f"{sum(r[1] for r in rows)} device events, device idle share "
          f"{1 - busy_us / wall_us:.3f} on {card}")
    top = sorted(rows, reverse=True)[:15]
    top += [r for r in rows if any(k in r[2] for k in keep) and r not in top]
    for t_us, count, key in top:
        print(f"  {t_us / 1e3:8.2f} ms {count:6d}x {t_us / count:8.2f} us  "
              f"{key[:100]}")
    # where the host's time goes: operators by their own CPU time
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)[:8]
    print(f"  host operators by self CPU time ({label}):")
    for t_us, count, key in host:
        print(f"  {t_us / 1e3:8.2f} ms {count:6d}x {t_us / count:8.2f} us  "
              f"{key[:100]}")


def phase_profile(model, card):
    """One protocol run under torch.profiler."""
    import torch

    from tecogan_tpu_torch.models.networks import infer_sequence

    lr = torch.rand((64, 134, 320, 3), device=model.device)
    infer_sequence(model.net_g, lr, model.cfg_g, chunk=64)
    _profile(lambda: infer_sequence(model.net_g, lr, model.cfg_g, chunk=64),
             "64 frames", card, ("warp_planes_kernel",))


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


# ---------------------------------------------------------------- training

_CB = {"type": "CB", "weight": 1, "reduction": "mean"}
TRAIN_T, TRAIN_BATCH, TRAIN_STEPS = 10, 2, 5
# card vs CPU, one training step: fp32 (TF32 off) losses within rtol 1e-4
# and each parameter's gradient within relative L2 error 1e-3 (sums taken
# in another order); bf16 mixed precision on the card against fp32 on the
# CPU: losses within 2% and gradient cosine similarity >= 0.99
STEP_F32_RTOL, STEP_F32_GRAD_REL = 1e-4, 1e-3
STEP_BF16_RTOL, STEP_BF16_GRAD_COS = 2e-2, 0.99


def _train_opt(ckpt_dir):
    """experiments_BD/FRVSR/FRVSR_VimeoTecoGAN_4xSR_2GPU/train.yml, in
    memory, on card 0: nf=64, nb=10, 4x BD sigma 1.5, batch 2 per card,
    tempo_extent 10, crop 128, CB pixel + warp losses, Adam 1e-4
    MultiStepLR, mixed precision and remat on."""
    return {
        "scale": SCALE, "manual_seed": SEED, "device_ids": [0],
        "is_train": True,
        "dataset": {"degradation": {"type": "BD", "sigma": 1.5},
                    "train": {"crop_size": 128,
                              "batch_size_per_gpu": TRAIN_BATCH}},
        "model": {"name": "FRVSR", "generator": {
            "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": NF, "nb": NB,
            "remat": True}},
        "train": {
            "tempo_extent": TRAIN_T, "mixed_precision": True,
            "ckpt_dir": ckpt_dir, "pixel_crit": _CB, "warping_crit": _CB,
            "generator": {"lr": 1e-4, "betas": [0.9, 0.999],
                          "lr_schedule": {"type": "MultiStepLR",
                                          "milestones": [150000, 300000],
                                          "gamma": 0.5}}},
        "logger": {"decay": 0.99},
    }


def _gt_clips(rng, n, t, size):
    """uint8 (n, t, size, size, 3) GT clips with motion, as the host loader
    ships them."""
    return np.stack([(_smooth_frames(rng, t, size, size) * 255).round()
                     .astype(np.uint8) for _ in range(n)])


def _expected_launches(t, remat):
    """Kernel launches of one FRVSR step, from its structure: one K2 per
    forward warp (t HR warps, one warping-loss warp), plus one per HR warp
    recomputed under remat; one K3 per warp whose image needs a gradient
    (every HR warp but frame 0's zero carry; not the loss's LR data); one
    K4 per warp whose flow needs a gradient (every warp but frame 0's zero
    flow)."""
    return {"K2": t + 1 + (t if remat else 0), "K3": t - 1, "K4": t}


def _kernel_counters():
    from tecogan_tpu_torch.ops.warp_cuda import warp_planes, warp_rgb
    from tecogan_tpu_torch.ops.warp_vjp import warp_dflow, warp_dimage

    return {"K1": warp_planes, "K2": warp_rgb, "K3": warp_dimage,
            "K4": warp_dflow}


def phase_train(rng, card):
    """Five full-width training steps through VSRModel.train. Returns the
    K2/K3/K4 launch counts of that run."""
    import torch

    from tecogan_tpu_torch.models import VSRModel

    with tempfile.TemporaryDirectory() as ckpt_dir:
        opt = _train_opt(ckpt_dir)
        model = VSRModel(opt)
        cfg = model.cfg_g
        _require(cfg.remat and model.tcfg.mixed_precision
                 and all(p.dtype == torch.float32
                         for p in model.net_g.parameters()),
                 "the trainer is not fp32 masters + bf16 compute + remat")
        size = 128 + 2 * int(1.5 * 3)  # crop + 2 * bd_border_size(1.5)
        batches = [_gt_clips(rng, TRAIN_BATCH, TRAIN_T, size)
                   for _ in range(TRAIN_STEPS)]
        w0 = {k: v.clone() for k, v in model.net_g.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        counters = _kernel_counters()
        for c in counters.values():
            c.launches = 0
        times = []
        for k, gt in enumerate(batches):
            batch = model.prepare_training_data({"gt": gt})
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logs = model.train(batch)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            print(f"train step {k}: l_pix_G {float(logs['l_pix_G']):.5f} "
                  f"l_warp_G {float(logs['l_warp_G']):.5f} "
                  f"({times[-1]:.2f} ms, CUDA events)")
            _require(all(math.isfinite(float(v)) for v in logs.values()),
                     f"step {k}: non-finite logs {logs}")
        launches = {k: c.launches for k, c in counters.items()}
        per_step = _expected_launches(TRAIN_T, cfg.remat)
        expected = {"K1": 0, **{k: TRAIN_STEPS * v
                                for k, v in per_step.items()}}
        print(f"training launches in {TRAIN_STEPS} steps: {launches}, "
              f"expected from the structure (t={TRAIN_T}, remat): "
              f"{expected}")
        _require(launches == expected, "the training path's kernel launch "
                 "counts differ from its structure")
        changed = sum(not torch.equal(w0[k], v)
                      for k, v in model.net_g.state_dict().items())
        _require(changed == len(w0), f"only {changed} of {len(w0)} weight "
                 f"tensors changed")
        print(f"ms/step at full width (nf={NF}, nb={NB}, batch "
              f"{TRAIN_BATCH}x{TRAIN_T}x{size}^2 uint8 GT, bf16, remat): "
              f"{min(times[1:]):.2f} (min of steps 1-{TRAIN_STEPS - 1} after "
              f"the warm-up step 0; all {[round(x, 2) for x in times]}) on "
              f"{card}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        batch = model.prepare_training_data({"gt": batches[0]})
        _profile(lambda: model.train(batch), "one training step", card,
                 ("warp_rgb_kernel", "warp_dimage_kernel",
                  "warp_dflow_kernel"))

        model.save(model.state["step"])
        model.save_training_state_now(model.state["step"])
        fresh = VSRModel(opt)
        state, resumed = fresh.try_resume(fresh.state)
        _require(resumed and state["step"] == model.state["step"],
                 f"resume gave step {state['step']}")
        same = all(torch.equal(fresh.net_g.state_dict()[k], v)
                   for k, v in model.net_g.state_dict().items())
        a = model.state["opt_g"].state_dict()["state"]
        b = state["opt_g"].state_dict()["state"]
        same_adam = all(torch.equal(b[i][k], v) for i in a
                        for k, v in a[i].items())
        host_steps = all(s["step"].device.type == "cpu"
                         for s in state["opt_g"].state.values())
        _require(same and same_adam and host_steps,
                 "resumed weights or Adam state differ")
        print(f"save + resume: G_iter{state['step']}.npz and "
              f"state_iter{state['step']}.pth written; a fresh model resumed "
              f"step {state['step']} with identical weights and Adam state")
    return {k: launches[k] for k in ("K2", "K3", "K4")}


def _one_step(sd, batch, device, mixed):
    """One FRVSR step at t=3 from the state dict ``sd`` on ``device``.
    Returns (logs as floats, {name: gradient as fp32 CPU tensor})."""
    import torch

    from tecogan_tpu_torch.models import schedules, steps
    from tecogan_tpu_torch.models.networks import FRNet, FRNetConfig

    cfg = FRNetConfig(nf=NF, nb=NB, scale=SCALE)
    net = FRNet.from_state_dict(cfg, sd, device)
    tcfg = steps.TrainConfig(scale=SCALE, degradation="BD", sigma=1.5,
                             pixel_crit=_CB, warping_crit=_CB,
                             mixed_precision=mixed)
    opt, sched = schedules.make_adam({"lr": 1e-4}, net.parameters())
    state = steps.frvsr_init_state(net, opt)
    _, logs = steps.frvsr_train_step(
        state, {"gt": torch.from_numpy(batch).to(device)}, cfg_g=cfg,
        tcfg=tcfg, sched_g=sched)
    return ({k: float(v) for k, v in logs.items()},
            {k: p.grad.float().cpu() for k, p in net.named_parameters()})


def phase_train_card_vs_cpu(sd, rng):
    """One training step on the card and on the CPU, same weights and
    batch (nf=64, nb=10, t=3, LR 16x16)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = _gt_clips(rng, 2, 3, 16 * SCALE + 2 * int(1.5 * 3))
    cpu_logs, cpu_g = _one_step(sd, batch, "cpu", mixed=False)
    for mixed in (False, True):
        logs, grads = _one_step(sd, batch, "cuda", mixed=mixed)
        loss_rel = max(abs(logs[k] - cpu_logs[k]) / abs(cpu_logs[k])
                       for k in cpu_logs)
        rel = {k: float((grads[k] - cpu_g[k]).norm() / cpu_g[k].norm())
               for k in cpu_g}
        # float64: an fp32 cosine over millions of terms rounds past 1
        a = torch.cat([grads[k].flatten() for k in cpu_g]).double()
        b = torch.cat([cpu_g[k].flatten() for k in cpu_g]).double()
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
        worst = max(rel, key=rel.get)
        if mixed:
            ok = loss_rel <= STEP_BF16_RTOL and cos >= STEP_BF16_GRAD_COS
            band = (f"losses <= {STEP_BF16_RTOL}, cosine >= "
                    f"{STEP_BF16_GRAD_COS}")
        else:
            ok = (loss_rel <= STEP_F32_RTOL
                  and rel[worst] <= STEP_F32_GRAD_REL)
            band = (f"losses <= {STEP_F32_RTOL}, per-parameter gradient "
                    f"<= {STEP_F32_GRAD_REL}")
        print(f"train step card {'bf16 mixed' if mixed else 'fp32'} vs CPU "
              f"fp32 (nf={NF}, nb={NB}, t=3, LR 16x16, TF32 off): losses "
              f"{logs} vs {cpu_logs}, max rel diff {loss_rel:.3g}; "
              f"gradient max rel L2 {rel[worst]:.3g} ({worst}), cosine "
              f"{cos:.6f} [{band}]: {'ok' if ok else 'FAIL'}")
        _require(ok, f"card {'bf16' if mixed else 'fp32'} training step "
                 f"outside its band")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tecogan_tpu_torch import kernel_build
    from tecogan_tpu_torch.models.convert import state_dict_from_jax
    from tecogan_tpu_torch.utils.ckpt import save_pytree

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
        save_pytree(params, ckpt)
        model, launches = phase_slice(ckpt, rng)
    phase_fps(model, card)
    phase_profile(model, card)
    del model
    sd = state_dict_from_jax(params, NB, SCALE)
    phase_card_vs_cpu(sd, rng)

    k234 = phase_k234(card)
    train_launches = phase_train(rng, card)
    phase_train_card_vs_cpu(sd, rng)

    _require("jax" not in sys.modules, "jax was imported")
    ms, plain_ms = timings["bf16"]
    rows = [{
        "name": "warp_planes", "route": "cuda",
        "source": "tecogan_tpu_torch/csrc/warp_planes.cu",
        "replaces": "tecogan_tpu/ops/warp_pallas.py:153",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]
    for key, name, source, replaces in (
            ("K2", "warp_rgb", "tecogan_tpu_torch/csrc/warp_rgb.cu",
             "tecogan_tpu/ops/warp_pallas.py:473"),
            ("K3", "warp_dimage", "tecogan_tpu_torch/csrc/warp_vjp.cu",
             "tecogan_tpu/ops/warp_vjp.py:156"),
            ("K4", "warp_dflow", "tecogan_tpu_torch/csrc/warp_vjp.cu",
             "tecogan_tpu/ops/warp_vjp.py:288")):
        err, ms, plain_ms = k234[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": train_launches[key],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
