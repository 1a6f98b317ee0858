"""Smoke run of the PyTorch/CUDA port (tecogan_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles the CUDA kernels (one nvcc per source, sm_90a) into
   build/kernels/;
3. K1 (the inference warp kernel) against its plain PyTorch version on the
   card, at the main path's shapes, test mode's (fp32, 576x720), the TPU
   kernel test's shapes and 1080p;
   K1's band mode at the row-folded geometries of 4 streams of 134x320 at
   4x and 3 streams at 2x, and at bands whose row tiles straddle two bands
   or hold several; K5 (the phase-plane warp) at the packed16 path's
   shape, the TPU kernel test's shapes and its extreme flows; for every
   kernel also ragged tiles (widths and heights off the tile, 1 and 2
   channels) and tensors one element off 16-byte alignment, so each branch
   of the kernels' launchers runs; K1 is timed on a smooth flow, as the
   path has, and on i.i.d. noise; each of K1, K1 band and K5 beside two
   controls: its own call with taps as coalesced as a copy (a zero flow)
   and a bf16 add over its output's size;
4. the inference path: a VSRModel at the flagship width (nf=64, nb=10, 4x,
   BD, bf16) serves three requests, and K1 must have been launched once
   per warped frame; then a torch.profiler breakdown of one run at
   bench.py's protocol;
5. test mode through the port's CLI (tecogan_tpu_torch.main, in process,
   card 0) on the shipped FRVSR test.yml with its paths replaced, at full
   width in fp32: a BD test set without LR frames (2 sequences x 12
   frames of 576x720, Vid4 calendar's geometry) and a BI one with LR
   frames made by imresize_matlab, each swept over two checkpoints
   (`*.npz`). One PNG per GT frame under its name, each bit-identical to
   VSRModel.infer; K1 once per warped frame and no other kernel; both
   sweep entries in the metrics JSON, PSNR equal to a recomputation from
   the PNGs; tOF gated where cv2 is absent. Host seconds per sequence
   (read, infer, write, metrics) and frames/s with and without PNG I/O;
   read_png's seconds a frame on files with row filters (cv2.imwrite's
   where cv2 imports, and every filter in turn) beside the port's own;
   then one 6-frame BD sequence through the CLI on the card against the
   CPU (--gpu_ids -1), and bf16 against fp32 over a 96-frame clip of
   134x320 (tests/test_golden.py's drift bound);
6. the packed16 path at the same width through infer_sequence_batch: K5
   once per warped frame, output against the default path's, the FPS of
   both at bench.py's protocol, in turns, and a profile;
7. the fold_streams path, 4 streams of 134x320: band-mode K1 once per
   frame, each stream against the unfolded batched path, the aggregate
   FPS of both, in turns, and a profile;
8. inference on the card against the CPU plain path, same weights and
   inputs, default and packed16;
9. K2, K3 and K4 (the training warp and its two adjoints), and K3 and K4
   in one launch, against their plain versions at the training shapes, the
   TPU kernel test's shapes and the 536x1280 HR frame, image and flow in
   f32 and bf16, NCHW and channels_last: all bit for bit (K3 against its
   fixed-point plain version, and near the float64 adjoint; the fused
   call's two outputs against K3's and K4's and their plain versions), two
   launches of K3 and of the fused call bit-identical; K3 and the fused
   call also with g zero, tiny, subnormal and non-finite; K3, K4 and the
   fused call one kernel launch a call, the cooperative grids one pass at
   the training shapes; with their times beside grid_sample's backward for
   the same gradients, and each kernel's zero-flow and streaming-add
   controls;
10. the training path: a VSRModel built like the Vimeo FRVSR train.yml
   (nf=64, nb=10, 4x BD, batch 2 x 10 frames of 136^2 uint8 GT, bf16 mixed
   precision, remat) takes five steps; the K2/K3/K4 launch counts (and the
   K3 launches fused with K4) must be exactly what the step's structure
   gives; ms/step, a profile of one step, then save and resume into a
   fresh model;
11. one training step on the card against the CPU, fp32 and bf16.

Every kernel is timed beside its plain version, its device time (from
torch.profiler), one PyTorch library call that computes the same function
(F.grid_sample or its backward, a yardstick the port never calls) and its
bound: the larger of its bytes (each input read once, each output written
once) over HBM bandwidth and its fp32 operations over the fp32 peak. The
second-to-last line lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import contextlib
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
# K5 and its plain version do the same fp32 operations in the same order:
# f32 output must be bit-identical, bf16 output (one fp32 value rounded)
# at most 1 bf16 ulp away
K5_BF16_ULPS = 1
# K1's band mode: (streams, scale, LR rows, LR columns) of the fold path's
# geometry and of a 2x one
BAND_GEOMETRIES = ((4, 4, 134, 320), (3, 2, 134, 320))
# band-mode cases whose 4-row tiles straddle two bands or hold several, as
# (streams, band, band_valid, width)
BAND_STRADDLES = ((3, 34, 30, 100), (4, 3, 2, 40), (6, 1, 1, 40))
FOLD_STREAMS = 4
# card bf16 packed16 against the card bf16 default path (the JAX package's
# band, tests/test_warp_pallas.py:121-122): the coordinates are f32 there
# and bf16 here; folded against unfolded, per stream
# (tests/test_fast_path.py:200-203)
P16_MAX_DIFF, P16_FRAC = 1, 0.02
FOLD_MAX_DIFF, FOLD_FRAC = 1, 1e-3
# published peaks of the H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bandwidth, and the fp32 rate outside the tensor cores, where the warps
# compute
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of each kernel per output pixel (coordinates, clamps,
# floors, weights) and per output pixel and channel (taps), counted from
# its source
KERNEL_OPS = {"K1": (16, 7), "K2": (16, 7), "K3": (12, 10), "K4": (16, 16),
              "K3+K4": (28, 26), "K5": (18, 7)}


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


def _device_ms(fn, iters=20, tries=3):
    """Device time per call of ``fn`` from torch.profiler over ``iters``
    calls: each kernel's mean time per launch, times its launches per call,
    summed over the kernels (so a launch the profiler drops does not count
    as time saved). The profiler now and then records no device time at
    all: then it profiles again, ``tries`` times in all, and gives None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / iters))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count)
        if us:
            return us / 1e3
    return None


def _bound(kernel, inputs, outputs, pixels, channels):
    """The least time (ms) the card could take for a kernel's work, and
    what sets it: the bytes of ``inputs`` read once and ``outputs`` written
    once over HBM bandwidth, or its fp32 operations over the fp32 peak,
    whichever is larger."""
    per_pixel, per_tap = KERNEL_OPS[kernel]
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    ops = pixels * (per_pixel + channels * per_tap)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grid(flow, dtype):
    """F.grid_sample's grid (align_corners=True) for an (n, H, W, 2) flow:
    the warp's sample points, normalised."""
    import torch

    n, h, w, _ = flow.shape
    ii = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    jj = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    f = flow.float()
    return torch.stack([(jj + f[..., 0]) * (2.0 / (w - 1)) - 1.0,
                        (ii + f[..., 1]) * (2.0 / (h - 1)) - 1.0],
                       dim=-1).to(dtype)


def _time_kernel(label, card, kern, plain, library, bound):
    """Time a kernel's wrapper, its plain version and its library yardstick
    in turns (CUDA events, after a warm-up), and its device time."""
    for _ in range(10):
        kern()
        plain()
        library()
    k, p, lib = [], [], []
    for _ in range(2):  # in turns: kernel, plain, library, twice
        k.append(_cuda_ms(kern, 200))
        p.append(_cuda_ms(plain, 50))
        lib.append(_cuda_ms(library, 200))
    dev, lib_dev = _device_ms(kern), _device_ms(library)
    t = {"ms": min(k), "plain_ms": min(p), "library_ms": min(lib),
         "device_ms": dev, "library_device_ms": lib_dev,
         "bound_ms": bound[0], "bound_by": bound[1]}

    print(f"{label} (CUDA events, us/call): kernel {t['ms'] * 1e3:.2f} "
          f"[device {_us(dev)}], plain {t['plain_ms'] * 1e3:.2f}, library "
          f"{t['library_ms'] * 1e3:.2f} [device {_us(lib_dev)}]; bound "
          f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}) on {card}")
    return t


def _us(ms):
    return "not measured" if ms is None else f"{ms * 1e3:.2f} us"


def _controls(label, card, kern, plain, out):
    """Print the device time of ``kern``, a kernel call whose taps are as
    coalesced as a copy (held bit-exact to ``plain``), and of a bf16 add of
    two tensors of the output's size, a streaming yardstick of about the
    same bytes: together they bound what any tap pattern could save."""
    import torch

    _require(_equal(kern(), plain()),
             f"{label} disagrees with its plain version")
    a = torch.randn(out.shape, device=out.device).bfloat16()
    b = torch.randn(out.shape, device=out.device).bfloat16()
    for _ in range(10):
        kern()
        torch.add(a, b)
    print(f"{label} controls (device us/call): coalesced taps "
          f"{_us(_device_ms(kern))}, bf16 add over the output "
          f"{tuple(out.shape)} {_us(_device_ms(lambda: torch.add(a, b)))} "
          f"on {card}")


def phase_k1(card):
    """K1 against warp_planes_reference on the card. Returns K1's numbers
    at the main path's shape."""
    import torch
    import torch.nn.functional as F

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
    # test mode's call: a 576x720 HR frame (Vid4's geometry, its width off
    # the 64-column tile), planes and flow in the generator's dtype, the
    # flow as the NCHW view of one frame of a chunk's HR flows
    for pd in dts:
        for layout in ("nchw", "chunk"):
            for sigma in (6.0, 30.0, 300.0):
                cases.append(((1, 3, 576, 720), pd, pd, layout, sigma))
    # planes and flow that start off a 16-byte boundary (one element in),
    # and ragged tiles: widths off the 64-column tile and the 32-lane warp,
    # heights off the 4-row tile
    for shape in ((1, 3, 536, 1280), (1, 3, 13, 200), (2, 1, 5, 33)):
        for pd in dts:
            cases.append((shape, pd, pd, "offset", 30.0))

    max_err = 0.0
    for shape, pd, fd, layout, sigma in cases:
        n, c, h, w = shape
        planes = torch.randn(shape, generator=gen, device=dev).to(dts[pd])
        if layout == "chunk":  # frame 1 of a (n, 2 frames, 2, h, w) chunk
            flow = torch.randn((n, 2, 2, h, w), generator=gen,
                               device=dev)[:, 1] * sigma
        else:
            flow = torch.randn((n, 2, h, w), generator=gen,
                               device=dev) * sigma
        flow = flow.to(dts[fd])
        flow = (flow.permute(0, 2, 3, 1) if layout in ("nchw", "chunk")
                else flow.permute(0, 2, 3, 1).contiguous())
        if layout == "offset":
            planes, flow = _offset_by_one(planes), _offset_by_one(flow)
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

    # the main path's call: a bf16 HR frame and the (n, H, W, 2) view of
    # its bf16 NCHW HR flow, smooth as FNet's upsampled flow is (the row),
    # and i.i.d. noise (the worst case for the taps' cache lines); the
    # library call is grid_sample with border padding, whose normalised
    # coordinates round differently
    shape = (1, 3, 536, 1280)
    planes = torch.randn(shape, generator=gen, device=dev).bfloat16()
    for kind in ("i.i.d.", "smooth"):
        flow = (_smooth_flow(gen, dev, 1, 536, 1280, 6.0) if kind == "smooth"
                else torch.randn((1, 2, 536, 1280), generator=gen,
                                 device=dev) * 6.0)
        flow = flow.bfloat16().permute(0, 2, 3, 1)
        grid = _grid(flow, planes.dtype)
        out = warp_planes(planes, flow)
        t = _time_kernel(
            f"K1 time {shape} bf16 planes+flow, {kind} flow sigma 6", card,
            lambda: warp_planes(planes, flow),
            lambda: warp_planes_reference(planes, flow),
            lambda: F.grid_sample(planes, grid, mode="bilinear",
                                  padding_mode="border", align_corners=True),
            _bound("K1", (planes, flow), (out,), out[:, 0].numel(), 3))
    zero = torch.zeros_like(flow)
    _controls(f"K1 {shape} zero flow", card, lambda: warp_planes(planes, zero),
              lambda: warp_planes_reference(planes, zero), out)
    # test mode's call (fp32 planes and flow at 576x720, smooth flow):
    # timed and printed; the JSON line keeps the main path's shape
    tm = (1, 3, 576, 720)
    tm_planes = torch.randn(tm, generator=gen, device=dev)
    tm_flow = _smooth_flow(gen, dev, 1, 576, 720, 6.0).permute(0, 2, 3, 1)
    tm_grid = _grid(tm_flow, tm_planes.dtype)
    tm_out = warp_planes(tm_planes, tm_flow)
    _time_kernel(
        f"K1 time {tm} f32 planes+flow (test mode), smooth flow sigma 6",
        card, lambda: warp_planes(tm_planes, tm_flow),
        lambda: warp_planes_reference(tm_planes, tm_flow),
        lambda: F.grid_sample(tm_planes, tm_grid, mode="bilinear",
                              padding_mode="border", align_corners=True),
        _bound("K1", (tm_planes, tm_flow), (tm_out,), tm_out[:, 0].numel(),
               3))
    t["max_abs_err"] = max_err
    return t


def _offset_by_one(t):
    """A contiguous copy of t that starts one element into its allocation,
    so its pointer is off a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def phase_k1_band(card):
    """K1's band mode against warp_planes_reference(band=...) on the card,
    at the fold path's geometries. Returns K1 band's numbers at the 4-stream
    geometry."""
    import torch
    import torch.nn.functional as F

    from tecogan_tpu_torch.models.networks.frnet import _fold_geometry
    from tecogan_tpu_torch.ops.warp_cuda import (warp_planes,
                                                 warp_planes_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    # (streams, band, band_valid, width): the fold path's geometries, then
    # bands whose 4-row tiles straddle two bands (34 rows) or hold
    # several (3 rows)
    geometries = [(streams, _fold_geometry(s, h)[2], s * h, s * w)
                  for streams, s, h, w in BAND_GEOMETRIES]
    geometries += BAND_STRADDLES
    max_err, n_cases = 0.0, 0
    for streams, band, valid, ww in geometries:
        hh = streams * band
        for pd in dts:
            for fd in dts:
                for layout in ("nhwc", "nchw", "offset"):
                    for sigma in (6.0, 30.0, 300.0):
                        planes = torch.randn((1, 3, hh, ww), generator=gen,
                                             device=dev).to(dts[pd])
                        flow = (torch.randn((1, 2, hh, ww), generator=gen,
                                            device=dev) * sigma).to(dts[fd])
                        flow = flow.permute(0, 2, 3, 1)
                        if layout == "nhwc":
                            flow = flow.contiguous()
                        if layout == "offset":
                            planes = _offset_by_one(planes)
                            flow = _offset_by_one(flow)
                        torch.cuda.synchronize()
                        got = warp_planes(planes, flow, band, valid)
                        torch.cuda.synchronize()
                        ref = warp_planes_reference(planes, flow, band, valid)
                        err = float((got.float() - ref.float()).abs().max())
                        max_err = max(max_err, err)
                        ok = (torch.allclose(got, ref, rtol=K1_F32_TOL,
                                             atol=K1_F32_TOL) if pd == "f32"
                              else _bf16_ulps(got, ref) <= K1_BF16_ULPS)
                        _require(ok and got.dtype == planes.dtype,
                                 f"K1 band mode disagrees with its plain "
                                 f"version: {streams} streams of {band} "
                                 f"rows ({valid} valid) x {ww} planes={pd} "
                                 f"flow={fd}/{layout} sigma={sigma} "
                                 f"max_abs_err={err:.3g}")
                        n_cases += 1
    print(f"K1 band mode against its plain version: {n_cases} cases ok "
          f"((streams, band, valid, width) {geometries}, planes and flow "
          f"f32/bf16, flow NHWC, an NCHW view and a copy one element off "
          f"16-byte alignment (planes too), sigma 6/30/300); max abs err "
          f"{max_err:.3g}")

    # the fold path's call: 4 folded streams, bf16 planes and the
    # (n, H, W, 2) view of a smooth bf16 NCHW flow; the library call is
    # grid_sample on each stream's valid rows alone (the kernel also writes
    # the guard rows, which the path zeroes)
    n, s, h, w = BAND_GEOMETRIES[0]
    _, _, band = _fold_geometry(s, h)
    hh, ww, valid = n * band, s * w, s * h
    planes = torch.randn((1, 3, hh, ww), generator=gen,
                         device=dev).bfloat16()
    flow = _smooth_flow(gen, dev, 1, hh, ww, 6.0).bfloat16().permute(
        0, 2, 3, 1)
    x_lib = planes.reshape(3, n, band, ww)[:, :, :valid].transpose(0, 1)
    x_lib = x_lib.contiguous()
    grid = _grid(flow.reshape(n, band, ww, 2)[:, :valid], planes.dtype)
    out = warp_planes(planes, flow, band, valid)
    t = _time_kernel(
        f"K1 band time {tuple(planes.shape)} band={band} valid={valid} bf16 "
        f"planes+flow", card,
        lambda: warp_planes(planes, flow, band, valid),
        lambda: warp_planes_reference(planes, flow, band, valid),
        lambda: F.grid_sample(x_lib, grid, mode="bilinear",
                              padding_mode="border", align_corners=True),
        _bound("K1", (planes, flow), (out,), out[:, 0].numel(), 3))
    zero = torch.zeros_like(flow)
    _controls(f"K1 band {tuple(planes.shape)} zero flow", card,
              lambda: warp_planes(planes, zero, band, valid),
              lambda: warp_planes_reference(planes, zero, band, valid), out)
    t["max_abs_err"] = max_err
    return t


def _smooth_flow(gen, dev, n, hh, ww, sigma):
    """A smooth (n, 2, H, W) f32 flow: Gaussian noise times sigma at 1/16
    of the size, upsampled bilinearly, so neighbouring pixels move alike
    as FNet's upsampled flows do."""
    import torch
    import torch.nn.functional as F

    low = torch.randn((n, 2, max(hh // 16, 2), max(ww // 16, 2)),
                      generator=gen, device=dev) * sigma
    return F.interpolate(low, size=(hh, ww), mode="bilinear",
                         align_corners=False)


def _phase_coords(flow, s):
    """An (n, 2, H, W) HR flow -> clamped absolute per-phase HR coordinates
    sy, sx (n, s*s, H/s, W/s), f32 (tests/test_warp_pallas.py's
    construction)."""
    import torch

    n, _, hh, ww = flow.shape
    h, w = hh // s, ww // s
    f = flow.float().reshape(n, 2, h, s, w, s).permute(0, 1, 3, 5, 2, 4)
    f = f.reshape(n, 2, s * s, h, w)
    q = torch.arange(s * s, device=flow.device)
    py = (q // s).float()[:, None, None]
    px = (q % s).float()[:, None, None]
    ii = (s * torch.arange(h, device=flow.device)).float()[:, None]
    jj = (s * torch.arange(w, device=flow.device)).float()[None, :]
    return (torch.clamp(ii + py + f[:, 1], 0.0, hh - 1.0).contiguous(),
            torch.clamp(jj + px + f[:, 0], 0.0, ww - 1.0).contiguous())


# K5's cases as (n, s, h, w, flow, channels): the packed16 path's frame,
# the TPU kernel test's two shapes, its extreme flow (sigma 150 clipped to
# +-170 HR pixels, near the kernel's halo bound), ragged tiles (widths off
# the 32/s * 2-column tile, heights off the 4-row tile) and channel counts
# other than 3 (the kernel's channel loop)
K5_CASES = ((1, 4, 134, 320, "smooth", 3), (1, 4, 32, 128, "smooth", 3),
            (1, 2, 24, 256, "smooth", 3), (1, 4, 16, 128, "extreme", 3),
            (1, 4, 13, 33, "smooth", 3), (2, 2, 9, 45, "smooth", 2),
            (1, 4, 5, 20, "smooth", 1))


def phase_k5(card):
    """K5 against warp_phases_reference on the card. Returns K5's numbers
    at the packed16 path's shape."""
    import torch
    import torch.nn.functional as F

    from tecogan_tpu_torch.ops.warp_phases import (phase_planes, warp_phases,
                                                   warp_phases_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    max_err, n_cases = 0.0, 0
    for n, s, h, w, kind, c in K5_CASES:
        hh, ww = s * h, s * w
        for sigma in ((6.0, 30.0, 300.0) if kind == "smooth" else (150.0,)):
            if kind == "smooth":
                flow = _smooth_flow(gen, dev, n, hh, ww, sigma)
            else:
                flow = torch.clamp(torch.randn((n, 2, hh, ww), generator=gen,
                                               device=dev) * sigma,
                                   -170.0, 170.0)
            coords = _phase_coords(flow, s)
            off_coords = tuple(_offset_by_one(t) for t in coords)
            for pd in dts:
                hr = torch.randn((n, c, hh, ww), generator=gen,
                                 device=dev).to(dts[pd])
                view = phase_planes(hr, s)  # the path's carry, no copy
                # the view, a contiguous (n, s*s, c, h, w) copy, and the
                # view of a frame and coordinates one element off 16-byte
                # alignment
                for planes, (sy, sx) in (
                        (view, coords),
                        (view.contiguous().flatten(1, 2), coords),
                        (phase_planes(_offset_by_one(hr), s), off_coords)):
                    torch.cuda.synchronize()
                    got = warp_phases(planes, sy, sx, s)
                    torch.cuda.synchronize()
                    ref = warp_phases_reference(planes, sy, sx, s)
                    _require(got.dtype == hr.dtype
                             and got.shape == (n, c, s * s, h, w),
                             f"K5 output {got.dtype} {tuple(got.shape)}")
                    err = float((got.float() - ref.float()).abs().max())
                    max_err = max(max_err, err)
                    ok = (torch.equal(got, ref) if pd == "f32"
                          else _bf16_ulps(got, ref) <= K5_BF16_ULPS)
                    _require(ok, f"K5 disagrees with its plain version: "
                             f"{(n, s, h, w)} {kind} sigma={sigma} "
                             f"planes={pd}/{tuple(planes.stride())} "
                             f"max_abs_err={err:.3g}")
                    n_cases += 1
    print(f"K5 against its plain version: {n_cases} cases ok ({K5_CASES}, "
          f"sigma 6/30/300 smooth, planes f32 (bit-exact) and bf16 (<= "
          f"{K5_BF16_ULPS} ulp), the HR frame's phase-plane view, a "
          f"contiguous (n, s*s, c, h, w) copy, and a view and coordinates "
          f"one element off 16-byte alignment); max abs err {max_err:.3g}")

    # the packed16 path's call: the bf16 HR frame's phase-plane view and
    # f32 coordinates; the library call is grid_sample on the HR frame with
    # the grid in phase order, zero padding as K5's halo
    n, s, h, w, _, _ = K5_CASES[0]
    hh, ww = s * h, s * w
    sy, sx = _phase_coords(_smooth_flow(gen, dev, n, hh, ww, 6.0), s)
    hr = torch.randn((n, 3, hh, ww), generator=gen, device=dev).bfloat16()
    view = phase_planes(hr, s)
    grid = torch.stack([sx * (2.0 / (ww - 1)) - 1.0,
                        sy * (2.0 / (hh - 1)) - 1.0], dim=-1)
    grid = grid.reshape(n, s * s * h, w, 2).bfloat16()
    out = warp_phases(view, sy, sx, s)
    t = _time_kernel(
        f"K5 time {(n, s * s, 3, h, w)} bf16 planes, f32 coordinates", card,
        lambda: warp_phases(view, sy, sx, s),
        lambda: warp_phases_reference(view, sy, sx, s),
        lambda: F.grid_sample(hr, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True),
        _bound("K5", (hr, sy, sx), (out,), sy.numel(), 3))
    sy0, sx0 = _phase_coords(torch.zeros((n, 2, hh, ww), device=dev), s)
    _controls(f"K5 {(n, s * s, 3, h, w)} at its pixels' own coordinates",
              card, lambda: warp_phases(view, sy0, sx0, s),
              lambda: warp_phases_reference(view, sy0, sx0, s), out)
    t["max_abs_err"] = max_err
    return t


# K2 is held to K1's tolerances (same arithmetic, same rounding). K4 adds
# the channels in fp32 in order, as its plain version does: bit for bit. K3
# sums exact integers: bit for bit its fixed-point plain version, the same
# bits in two launches, and against the float64 adjoint rtol 1e-4, with an
# atol of 1e-5 * max|ref|. The fused launch: bit for bit K3 and K4.
K3_RTOL, K3_ATOL_REL = 1e-4, 1e-5
# the two training warps at full width: HR (batch 2, 128^2 GT crop) and the
# warping loss's LR warp (2 x 9 frame pairs of 32^2)
TRAIN_WARP_SHAPES = ((2, 3, 128, 128), (18, 3, 32, 32))
# tests/test_warp_vjp.py's shapes, as (n, c, h, w), and the HR frame of
# inference, where K3's grid-stride loops take more than one pass
VJP_TEST_SHAPES = ((2, 3, 32, 48), (1, 3, 17, 23), (2, 3, 40, 128),
                   (1, 3, 64, 128), (1, 3, 536, 1280))


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


def _equal(a, b, nan=False):
    """Bit for bit, for tensors or tuples of them; ``nan``: NaN where the
    other is NaN (its bits may differ), every other value equal."""
    import torch

    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(u, v, nan)
                                        for u, v in zip(a, b))
    if not nan:
        return a.dtype == b.dtype and torch.equal(a, b)
    return a.dtype == b.dtype and torch.allclose(
        a.float(), b.float(), rtol=0.0, atol=0.0, equal_nan=True)


def phase_k234(card):
    """K2, K3, K4 and K3 with K4 in one launch against their plain versions
    on the card. Returns {kernel: its numbers}, the times at the HR
    training warp in bf16."""
    import torch
    import torch.nn.functional as F

    from tecogan_tpu_torch.ops.warp_cuda import warp_planes_reference, warp_rgb
    from tecogan_tpu_torch.ops.warp_vjp import (warp_dflow,
                                                warp_dflow_reference,
                                                warp_dimage,
                                                warp_dimage_dflow,
                                                warp_dimage_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    err = {"K2": 0.0, "K3": 0.0, "K4": 0.0, "K3+K4": 0.0}
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

                        # K3 in fp32 twice (the same bits) and in the image
                        # dtype, each bit for bit its fixed-point plain
                        # version, and near the float64 adjoint
                        a = warp_dimage(g, flow, torch.float32)
                        b = warp_dimage(g, flow, torch.float32)
                        low = warp_dimage(g, flow, dts[xd])
                        torch.cuda.synchronize()
                        _require(torch.equal(a, b), f"K3 differs between "
                                 f"two launches: {tag}")
                        plain_dx = warp_dimage_reference(g, flow, dts[xd])
                        _require(
                            torch.equal(a, warp_dimage_reference(
                                g, flow, torch.float32))
                            and torch.equal(low, plain_dx)
                            and low.stride() == g.stride(),
                            f"K3 differs from its fixed-point plain "
                            f"version: {tag}")
                        ref = warp_dimage_reference(g.double(), flow,
                                                    torch.float64)
                        atol = K3_ATOL_REL * float(ref.abs().max())
                        e = float((a.double() - ref).abs().max())
                        err["K3"] = max(err["K3"], e)
                        _require(torch.allclose(a.double(), ref, rtol=K3_RTOL,
                                                atol=atol),
                                 f"K3 disagrees with the float64 adjoint: "
                                 f"{tag} max_abs_err={e:.3g}")

                        # K4 alone, bit for bit its plain version
                        got = warp_dflow(g, x, flow)
                        torch.cuda.synchronize()
                        plain_df = warp_dflow_reference(g, x, flow)
                        _require(got.dtype == flow.dtype
                                 and got.shape == (n, h, w, 2),
                                 f"K4 output {got.dtype} {tuple(got.shape)}")
                        e = float((got.float() - plain_df.float()).abs().max())
                        err["K4"] = max(err["K4"], e)
                        _require(torch.equal(got, plain_df),
                                 f"K4 disagrees with its plain version: "
                                 f"{tag} max_abs_err={e:.3g}")

                        # K3 and K4 in one launch, twice: the same bits, and
                        # bit for bit K3's, K4's and their plain versions'
                        dx, df = warp_dimage_dflow(g, x, flow)
                        again = warp_dimage_dflow(g, x, flow)
                        torch.cuda.synchronize()
                        _require(_equal((dx, df), again), f"K3+K4 differs "
                                 f"between two launches: {tag}")
                        e = max(float((dx.float() - plain_dx.float()).abs()
                                      .max()),
                                float((df.float() - plain_df.float()).abs()
                                      .max()))
                        err["K3+K4"] = max(err["K3+K4"], e)
                        _require(_equal((dx, df), (low, got))
                                 and _equal((dx, df), (plain_dx, plain_df))
                                 and dx.stride() == g.stride(),
                                 f"K3+K4 differs from K3, K4 or their plain "
                                 f"versions: {tag} max_abs_err={e:.3g}")
                        n_cases += 1
    print(f"K2/K3/K4/K3+K4 against their plain versions: {n_cases} cases ok "
          f"(shapes {TRAIN_WARP_SHAPES + VJP_TEST_SHAPES}, sigma 6/30/300, "
          f"image and flow f32/bf16, NCHW and channels_last); max abs err "
          f"K2 {err['K2']:.3g}, K3 0 against its fixed-point plain version "
          f"({err['K3']:.3g} against the float64 adjoint), K4 "
          f"{err['K4']:.3g}, K3+K4 {err['K3+K4']:.3g} (its dx and dflow "
          f"equal K3's and K4's); run-to-run spread over two launches 0 in "
          f"every case for K3 and K3+K4")
    _k3_edge_cases(gen, dev)
    _one_pass_grids()

    # the library calls: grid_sample with border padding for K2, and
    # grid_sample's backward for the same gradients as K3 (the image's),
    # K4 (the grid's) and the fused call (both)
    out = {}
    for shape in TRAIN_WARP_SHAPES:
        n, c, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev).bfloat16()
        g = torch.randn(shape, generator=gen, device=dev).bfloat16()
        flow = (torch.randn((n, h, w, 2), generator=gen, device=dev)
                * 6.0).bfloat16()
        grid = _grid(flow, x.dtype)

        def lib_vjp(mask, grid=grid, x=x, g=g):
            return lambda: torch.ops.aten.grid_sampler_2d_backward(
                g, x, grid, 0, 1, True, mask)

        pixels = n * h * w
        cases = {
            "K2": (lambda: warp_rgb(x, flow),
                   lambda: warp_planes_reference(x, flow),
                   lambda: F.grid_sample(x, grid, mode="bilinear",
                                         padding_mode="border",
                                         align_corners=True),
                   _bound("K2", (x, flow), (x,), pixels, c)),
            "K3": (lambda: warp_dimage(g, flow, torch.bfloat16),
                   lambda: warp_dimage_reference(g, flow, torch.bfloat16),
                   lib_vjp([True, False]),
                   _bound("K3", (g, flow), (x,), pixels, c)),
            "K4": (lambda: warp_dflow(g, x, flow),
                   lambda: warp_dflow_reference(g, x, flow),
                   lib_vjp([False, True]),
                   _bound("K4", (g, x, flow), (flow,), pixels, c)),
            "K3+K4": (lambda: warp_dimage_dflow(g, x, flow),
                      lambda: (warp_dimage_reference(g, flow, x.dtype),
                               warp_dflow_reference(g, x, flow)),
                      lib_vjp([True, True]),
                      _bound("K3+K4", (g, x, flow), (x, flow), pixels, c)),
        }
        for name, (kern, plain, library, bound) in cases.items():
            t = _time_kernel(f"{name} time {shape} bf16 image+flow", card,
                             kern, plain, library, bound)
            if shape == TRAIN_WARP_SHAPES[0]:
                out[name] = {**t, "max_abs_err": err[name]}
        zero = torch.zeros_like(flow)
        if shape == TRAIN_WARP_SHAPES[0]:
            _controls(f"K2 {shape} zero flow", card,
                      lambda: warp_rgb(x, zero),
                      lambda: warp_planes_reference(x, zero), x)
            _controls(f"K3 {shape} zero flow", card,
                      lambda: warp_dimage(g, zero, torch.bfloat16),
                      lambda: warp_dimage_reference(g, zero, torch.bfloat16),
                      x)
        _controls(f"K4 {shape} zero flow", card,
                  lambda: warp_dflow(g, x, zero),
                  lambda: warp_dflow_reference(g, x, zero), flow)
        _controls(f"K3+K4 {shape} zero flow", card,
                  lambda: warp_dimage_dflow(g, x, zero),
                  lambda: (warp_dimage_reference(g, zero, x.dtype),
                           warp_dflow_reference(g, x, zero)),
                  torch.cat([x.flatten(), flow.flatten()]))
        for name, fn, kernel in (
                ("K3", lambda: warp_dimage(g, flow, torch.bfloat16),
                 "warp_dimage_kernel"),
                ("K4", lambda: warp_dflow(g, x, flow), "warp_dflow_kernel"),
                ("K3+K4", lambda: warp_dimage_dflow(g, x, flow),
                 "warp_dimage_dflow_kernel")):
            names = _kernel_names(fn)
            print(f"{name}'s device work over 20 calls at {shape} "
                  f"(profiler, launches by kernel): {names}")
            _require(len(names) == 1 and kernel in next(iter(names)),
                     f"{name} is not one kernel launch a call")
    return out


def _one_pass_grids():
    """K3's and the fused launch's cooperative grids at the training
    shapes, capped by CUDA's occupancy query: each must hold every tile
    (one pass, the flow and g kept across the first barrier)."""
    from tecogan_tpu_torch.ops.warp_cuda import stride_grid, tile_plan
    from tecogan_tpu_torch.ops.warp_vjp import (_dimage_slots,
                                                dimage_resident_blocks)

    for name in ("tecogan_warp_dimage_bf16_bf16_bf16",
                 "tecogan_warp_dimage_dflow_bf16_bf16"):
        for n, c, h, w in TRAIN_WARP_SHAPES:
            resident = dimage_resident_blocks(name, 0, c)
            grid = stride_grid(n, c, h, w, min(resident, _dimage_slots(0)))
            tiles, _ = tile_plan(n, h, w, steps=1)
            print(f"{name} at {(n, c, h, w)}: {resident} co-resident blocks "
                  f"(occupancy query), grid {grid} over tiles {tiles}")
            _require(grid == tiles, f"{name} takes more than one pass at "
                     f"{(n, c, h, w)}")


def _k3_edge_cases(gen, dev):
    """K3 and the fused K3+K4 at the HR training warp with g all zero,
    scaled to 1e-30 and to 1e-40 (subnormal, so its scale lies past fp32's
    range), bit for bit their plain versions; with one inf and one NaN in
    g, the image adjoint non-finite exactly where its plain version is and
    the flow adjoint (a plain gather) equal to its plain version, NaN where
    it is NaN."""
    import torch

    from tecogan_tpu_torch.ops.warp_vjp import (warp_dflow,
                                                warp_dflow_reference,
                                                warp_dimage,
                                                warp_dimage_dflow,
                                                warp_dimage_reference)

    shape = TRAIN_WARP_SHAPES[0]
    n, c, h, w = shape
    flow = _vjp_flow(gen, dev, n, h, w, 6.0)

    def same_dx(got, ref, nonfinite):
        if not nonfinite:
            return torch.equal(got, ref)
        return (torch.equal(torch.isfinite(got), torch.isfinite(ref))
                and torch.equal(torch.isnan(got), torch.isnan(ref))
                and not bool(torch.isfinite(got).all()))

    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn(shape, generator=gen, device=dev).to(dt)
        x = torch.rand(shape, generator=gen, device=dev).to(dt)
        bad = g.clone()
        bad[0, 1, 3, 4] = float("inf")
        bad[n - 1, c - 1, h * 3 // 4, w // 6] = float("nan")
        for label, gg in (("zero", g * 0), ("1e-30", g * 1e-30),
                          ("1e-40", g * 1e-40), ("inf and nan", bad)):
            nonfinite = label == "inf and nan"
            for xd in (torch.float32, torch.bfloat16):
                got = warp_dimage(gg, flow, xd)
                torch.cuda.synchronize()
                ref = warp_dimage_reference(gg, flow, xd)
                _require(same_dx(got, ref, nonfinite),
                         f"K3 edge case g {label} ({dt} -> {xd}) differs "
                         f"from its plain version")
            dx, df = warp_dimage_dflow(gg, x, flow)
            df_alone = warp_dflow(gg, x, flow)
            torch.cuda.synchronize()
            ref_df = warp_dflow_reference(gg, x, flow)
            _require(same_dx(dx, warp_dimage_reference(gg, flow, dt),
                             nonfinite)
                     and _equal(df, ref_df, nan=True)
                     and _equal(df_alone, ref_df, nan=True)
                     and nonfinite == bool(torch.isnan(df).any()),
                     f"K3+K4 or K4 edge case g {label} ({dt}) differs from "
                     f"the plain versions")
    print("K3 and K3+K4 edge cases (g zero, 1e-30, 1e-40, one inf and one "
          "NaN; g and output f32/bf16): ok, bit for bit (the image "
          "adjoint's non-finite pattern and the flow adjoint's NaNs for inf "
          "and NaN); K4 alone likewise")


def _kernel_names(fn, iters=20):
    """{device kernel name: launches} over ``iters`` calls of ``fn``, from
    torch.profiler (which may drop a launch, never add one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


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

    model = VSRModel(_test_opt(ckpt))
    requests = [
        {"lr": _smooth_frames(rng, 32, 134, 320)},
        {"lr": _smooth_frames(rng, 32, 134, 320)},
        {"gt": (_smooth_frames(rng, 32, 536, 1280) * 255).round()
         .astype(np.uint8)},
    ]
    n_pad = model.opt["test"]["num_pad_front"]
    expected = 0
    _reset_counts()
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
    counts = _read_counts()
    print(f"launches in the main path: {counts}, frames warped: {expected}")
    _require(counts == {**dict.fromkeys(counts, 0), "K1": expected},
             "the main path did not launch K1 (not in band mode), and only "
             "K1, once per warped frame")
    return model, counts["K1"]


# --------------------------------------------------------------- test mode

TM_FRAMES, TM_GT = 12, (576, 720)  # Vid4 calendar's geometry: LR 144x180
TM_CPU_FRAMES = 6
# bf16 drift over a long clip (tests/test_golden.py:139-174)
DRIFT_T, DRIFT_LR, DRIFT_FLOOR, DRIFT_SLIDE = 96, (134, 320), 45.0, 6.0
SHIPPED_TEST_YML = "experiments_BD/FRVSR/FRVSR_VimeoTecoGAN_4xSR_2GPU/test.yml"


def _yaml_text(opt):
    """A nested dict of scalars as block YAML that the port's reader reads
    back to ``opt`` (the card has no PyYAML)."""
    from tecogan_tpu_torch.utils.yaml_subset import safe_load

    def scalar(v):
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, (int, float)):
            return repr(v)
        return "'" + str(v).replace("'", "''") + "'"

    def lines(d, indent):
        for k, v in d.items():
            if isinstance(v, dict):
                yield f"{' ' * indent}{k}:"
                yield from lines(v, indent + 2)
            else:
                yield f"{' ' * indent}{k}: {scalar(v)}"

    text = "\n".join(lines(opt, 0)) + "\n"
    _require(safe_load(text) == opt, "test.yml does not read back")
    return text


def _write_seq(seq_dir, frames):
    from tecogan_tpu_torch.utils.png import write_png

    os.makedirs(seq_dir)
    for i, f in enumerate(frames):
        write_png(os.path.join(seq_dir, f"{i:04d}.png"), f)


def _write_png_filtered(path, rgb):
    """(h, w, 3) uint8 RGB -> an 8-bit RGB PNG whose rows cycle through the
    five row filters (None, Sub, Up, Average, Paeth), as files from other
    encoders mix them (the port's write_png uses None only)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    x = rgb.reshape(h, 3 * w).astype(np.int32)
    a = np.pad(x, ((0, 0), (3, 0)))[:, :-3]  # left, upper, upper-left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (3, 0)))[:-1, :-3]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ftype = np.arange(h) % 5
    pred = np.select([ftype[:, None] == k for k in range(4)],
                     [0, a, b, (a + b) >> 1], paeth)
    rows = np.concatenate([ftype[:, None], (x - pred) & 0xFF], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.astype(np.uint8)
                                               .tobytes(), 1))
                + chunk(b"IEND", b""))


def _filter_mix(path):
    """How many rows of an 8-bit PNG use each row filter (0-4)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        buf = f.read()
    pos, idat = 8, []
    while pos < len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", data[:10])
        elif kind == b"IDAT":
            idat.append(data)
        pos += 12 + length
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return np.bincount(rows.reshape(h, 1 + w * bpp)[:, 0],
                       minlength=5).tolist()


def _png_read_times(tmp, frames, card):
    """read_png's host seconds a frame on the same frames written three
    ways: by the port's write_png (row filter None), with every row filter
    in turn, and by cv2.imwrite where cv2 imports (libpng's own choice of
    filters, as the real test sets' files have). Each file must decode to
    the frame written."""
    from tecogan_tpu_torch.utils.png import read_png, write_png

    writers = {"write_png (filter None)": write_png,
               "five filters in turn": _write_png_filtered}
    try:
        import cv2
    except ImportError:
        print("read_png on cv2.imwrite's files: not measured (no cv2)")
    else:
        writers["cv2.imwrite"] = lambda p, f: cv2.imwrite(p, f[..., ::-1])
    paths = {}
    for i, (kind, write) in enumerate(writers.items()):
        os.makedirs(f"{tmp}/png{i}")
        paths[kind] = [f"{tmp}/png{i}/{j:04d}.png" for j in range(len(frames))]
        for p, f in zip(paths[kind], frames):
            write(p, f)
    secs = {kind: [] for kind in writers}
    for _ in range(2):  # in turns, twice; the faster pass is kept
        for kind, ps in paths.items():
            t0 = time.perf_counter()
            got = [read_png(p) for p in ps]
            secs[kind].append((time.perf_counter() - t0) / len(ps))
            _require(all(np.array_equal(g, f) for g, f in zip(got, frames)),
                     f"read_png does not decode {kind}'s files")
    h, w = frames.shape[1:3]
    for kind, ps in paths.items():
        print(f"read_png on {len(ps)} frames of {h}x{w} by {kind} (rows "
              f"per filter 0-4 in the first file: {_filter_mix(ps[0])}): "
              f"{min(secs[kind]):.4f} s a frame (host clock, passes "
              f"{[round(x, 4) for x in secs[kind]]}) on {card}")


def _test_mode_opt(tmp, name, degradation, test_set, load_path, metric):
    """The shipped FRVSR test.yml with its paths replaced."""
    from tecogan_tpu_torch.utils.yaml_subset import safe_load

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           SHIPPED_TEST_YML)) as f:
        opt = safe_load(f.read())
    exp = os.path.join(tmp, f"exp_{name}")
    opt["dataset"] = {"degradation": degradation,
                      "test1": {"name": "Vid4", **test_set,
                                "num_worker_per_gpu": 3, "pin_memory": True}}
    # the shipped width (nf=64, nb=10) unless a rehearsal cuts it
    opt["model"]["generator"].update(nf=NF, nb=NB, load_path=load_path)
    opt["test"].update({"save_res": True, "res_dir": f"{exp}/results",
                        "save_json": True, "json_dir": f"{exp}/metrics",
                        "start_iter": 1, "end_iter": 2, "test_freq": 1})
    opt["metric"] = metric
    os.makedirs(exp)
    path = os.path.join(exp, "test.yml")
    with open(path, "w") as f:
        f.write(_yaml_text(opt))
    return exp, path, opt["test"]["num_pad_front"]


class _Warnings:
    """Collects the WARNING records of the port's 'base' logger."""

    def __enter__(self):
        import logging

        self.records = []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = self.records.append
        logging.getLogger("base").addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        import logging

        logging.getLogger("base").removeHandler(self.handler)


@contextlib.contextmanager
def _blocked(module):
    """``import module`` raises inside the block (``None`` blocks nothing)."""
    saved = sys.modules.get(module)
    if module:
        sys.modules[module] = None
    try:
        yield
    finally:
        if module and saved is None:
            del sys.modules[module]
        elif module:
            sys.modules[module] = saved


def _cli(exp, yml, gpu_ids):
    """The port's CLI in process; returns (records, seconds, warnings)."""
    from tecogan_tpu_torch.main import main as cli_main

    with _Warnings() as warns:
        t0 = time.perf_counter()
        records = cli_main(["--exp_dir", exp, "--mode", "test", "--opt", yml,
                            "--gpu_ids", gpu_ids])
        secs = time.perf_counter() - t0
    return records, secs, [w.getMessage() for w in warns]


def _psnr_y(gt, sr):
    """PSNR on Y of two uint8 RGB frames, from the PNGs' pixels."""
    from tecogan_tpu_torch.ops.color import rgb_to_ycbcr

    a = rgb_to_ycbcr(gt)[..., 0].astype(np.float64)
    b = rgb_to_ycbcr(sr)[..., 0].astype(np.float64)
    return 20 * np.log10(255.0 / np.sqrt(np.mean((a - b) ** 2)))


def _check_test_run(label, opt_path, exp, records, warns, tof):
    """Requirements (a), (b), (d), (e) on one CLI run of test mode; tOF is
    computed if ``tof`` (cv2 could be imported), else gated."""
    import json as _json

    import torch

    from tecogan_tpu_torch.data import create_test_dataset
    from tecogan_tpu_torch.models import define_model
    from tecogan_tpu_torch.utils import config as config_utils
    from tecogan_tpu_torch.utils import paths as path_utils
    from tecogan_tpu_torch.utils.png import read_png

    args = config_utils.parse_args(["--exp_dir", exp, "--mode", "test",
                                    "--opt", opt_path, "--gpu_ids", "0"])
    opt = config_utils.parse_configs(args)
    path_utils.setup_paths(opt, "test")
    dataset = create_test_dataset(opt, "test1")
    gt_dir = opt["dataset"]["test1"]["gt_seq_dir"]
    res = os.path.join(exp, "results", "Vid4")
    with open(os.path.join(exp, "metrics", "Vid4_avg.json")) as f:
        summary = _json.load(f)
    _require(list(summary) == ["G_iter1", "G_iter2"],
             f"{label}: metrics JSON entries {list(summary)}")
    # (e) tOF where cv2 imports, else its gate: one WARNING, no tOF
    tof_warns = [w for w in warns if "tOF disabled" in w]
    if tof:
        _require(not tof_warns and all(
            np.isfinite(float(e["tOF"])) for e in summary.values()),
                 f"{label}: cv2 imports but tOF was not computed")
    else:
        _require(len(tof_warns) == 1 and "cv2" in tof_warns[0]
                 and all(list(e) == ["PSNR", "SSIM"]
                         for e in summary.values()),
                 f"{label}: tOF not gated with one WARNING: {warns}")
    print(f"test mode {label}: tOF "
          + (f"computed: {summary['G_iter1']['tOF']}, "
             f"{summary['G_iter2']['tOF']}" if tof
             else f"gated ({tof_warns[0]})"))
    for k in ("PSNR", "SSIM"):
        v1, v2 = float(summary["G_iter1"][k]), float(summary["G_iter2"][k])
        _require(np.isfinite(v1) and np.isfinite(v2) and v1 != v2,
                 f"{label}: {k} {v1}, {v2} not finite and different")

    model, n_pngs, infer_s, infer_frames = None, 0, 0.0, 0
    for it in (1, 2):
        idx, ckpt = f"G_iter{it}", opt["model"]["generator"][
            "load_path_lst"][it - 1]
        if model is None:
            opt["model"]["generator"]["load_path"] = ckpt
            model = define_model(opt)
        else:
            model.load_generator(ckpt)
        psnr_seqs = []
        for i in range(len(dataset)):
            data = dataset[i]
            seq = data["seq_idx"]
            # (a) one PNG per GT frame, under the GT's file names
            names = sorted(os.listdir(os.path.join(res, idx, seq)))
            _require(names == sorted(os.listdir(os.path.join(gt_dir, seq))),
                     f"{label}: {idx}/{seq} holds {names}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = model.infer(model.prepare_inference_data(data))
            infer_s += time.perf_counter() - t0
            infer_frames += len(want)
            # (b) the PNGs decode to VSRModel.infer's frames exactly
            got = np.stack([read_png(os.path.join(res, idx, seq, n))
                            for n in names])
            _require(got.shape == want.shape and np.array_equal(got, want),
                     f"{label}: {idx}/{seq} PNGs differ from VSRModel.infer")
            n_pngs += len(names)
            # (d) PSNR recomputed from the PNGs
            psnr = float(np.mean([_psnr_y(g, s) for g, s in
                                  zip(data["gt"], got)]))
            rec = [r for r in records
                   if r["model_idx"] == idx and r["seq_idx"] == seq]
            _require(len(rec) == 1 and abs(
                rec[0]["metrics"]["PSNR"] - psnr) <= 1e-9,
                     f"{label}: {idx}/{seq} PSNR {rec} against {psnr}")
            psnr_seqs.append(psnr)
        _require(abs(float(summary[idx]["PSNR"])
                     - np.mean(psnr_seqs)) <= 5e-7 + 1e-12,
                 f"{label}: {idx} JSON PSNR {summary[idx]['PSNR']} "
                 f"against {np.mean(psnr_seqs)}")
    print(f"test mode {label}: {n_pngs} PNGs bit-identical to "
          f"VSRModel.infer; PSNR/SSIM G_iter1 {summary['G_iter1']['PSNR']}/"
          f"{summary['G_iter1']['SSIM']}, G_iter2 "
          f"{summary['G_iter2']['PSNR']}/{summary['G_iter2']['SSIM']}, "
          f"PSNR equal to the PNGs' recomputation")
    return infer_frames, infer_s


def _report_times(label, records, secs, infer, card):
    frames = sum(r["frames"] for r in records)
    for r in records:
        print(f"test mode {label} {r['model_idx']}/{r['seq_idx']}: "
              f"{r['frames']} frames of {TM_GT[0]}x{TM_GT[1]}, host seconds "
              f"read {r['read_s']:.4f}, infer {r['infer_s']:.4f}, write "
              f"{r['write_s']:.4f}, metrics {r['metrics_s']:.4f} on {card}")
    split = {k: sum(r[k] for r in records)
             for k in ("read_s", "infer_s", "write_s", "metrics_s")}
    per_seq = sum(split.values())
    print(f"test mode {label} (fp32, nf={NF}, nb={NB}, {SCALE}x): {frames} "
          f"frames in {secs:.3f} s of CLI (model build and checkpoint loads "
          f"included), {per_seq:.3f} s over the sequences: "
          f"{frames / secs:.2f} frames/s with PNG I/O and metrics "
          f"({frames / per_seq:.2f} over the sequences); split "
          + ", ".join(f"{k[:-2]} {v / per_seq:.1%}" for k, v in split.items())
          + f"; VSRModel.infer alone on the same frames "
          f"{infer[0] / infer[1]:.2f} frames/s ({infer[1]:.3f} s) on {card}")


def phase_test_mode(card):
    """Test mode through the port's CLI (``tecogan_tpu_torch.main.main``)
    on card 0, at the flagship width, in fp32 as the shipped test.yml:
    a BD set without LR frames (2 x 12 frames of 576x720 GT) and a BI set
    with LR frames made by imresize_matlab (1 x 12), each swept over two
    checkpoints; then one 6-frame sequence on the CPU against the card,
    and the bf16 drift over a 96-frame clip."""
    import torch

    import importlib.util

    from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                   infer_sequence)
    from tecogan_tpu_torch.ops.color import float32_to_uint8
    from tecogan_tpu_torch.ops.degrade import imresize_matlab
    from tecogan_tpu_torch.utils.ckpt import (load_generator_params,
                                              save_pytree)
    from tecogan_tpu_torch.utils.png import read_png

    rng = np.random.default_rng(SEED + 7)
    metric = {"PSNR": {"colorspace": "y"}, "SSIM": None,
              "tOF": {"colorspace": "y"}}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for seq in ("calendar", "city"):
            _write_seq(f"{tmp}/BD/GT/{seq}", float32_to_uint8(
                _smooth_frames(rng, TM_FRAMES, *TM_GT)))
        gt = float32_to_uint8(_smooth_frames(rng, TM_FRAMES, *TM_GT))
        _write_seq(f"{tmp}/BI/GT/walk", gt)
        _write_seq(f"{tmp}/BI/LR/walk", float32_to_uint8(
            imresize_matlab(gt.astype(np.float64) / 255.0, scale=0.25)))
        _write_seq(f"{tmp}/BD6/GT/foliage", gt[:TM_CPU_FRAMES])
        os.makedirs(f"{tmp}/ckpt")
        for it in (1, 2):
            save_pytree(_jax_layout_params(rng, NF, NB, SCALE),
                        f"{tmp}/ckpt/G_iter{it}.npz")
        print(f"test mode: wrote {3 * TM_FRAMES + TM_CPU_FRAMES} GT and "
              f"{TM_FRAMES} LR PNGs and two checkpoints in "
              f"{time.perf_counter() - t0:.2f} s")
        _png_read_times(tmp, gt, card)

        # tOF needs cv2: the BD run computes it where cv2 is installed, the
        # BI run has cv2 blocked and shows the gate
        cv2_found = importlib.util.find_spec("cv2") is not None
        for label, deg, test_set, block in (
                ("BD", {"type": "BD", "sigma": 1.5},
                 {"gt_seq_dir": f"{tmp}/BD/GT"}, None),
                ("BI", {"type": "BI"}, {"gt_seq_dir": f"{tmp}/BI/GT",
                                        "lr_seq_dir": f"{tmp}/BI/LR"},
                 "cv2")):
            exp, yml, n_pad = _test_mode_opt(tmp, label, deg, test_set,
                                             f"{tmp}/ckpt/*.npz", metric)
            _reset_counts()
            with _blocked(block):
                records, secs, warns = _cli(exp, yml, "0")
            counts = _read_counts()
            expected = sum(_frames_warped(r["frames"] + n_pad, 16)
                           for r in records)
            print(f"test mode {label}: launches {counts}, frames warped "
                  f"{expected}")
            # (c) K1 once per warped frame, and no other warp kernel
            _require(counts == {**dict.fromkeys(counts, 0), "K1": expected},
                     f"test mode {label}: K1 not launched once per warped "
                     f"frame, or another kernel launched")
            infer = _check_test_run(label, yml, exp, records, warns,
                                    tof=cv2_found and block is None)
            _report_times(label, records, secs, infer, card)

        # (f) the card against the CPU, one BD sequence of 6 frames
        outs = {}
        for gpu_ids in ("0", "-1"):
            exp, yml, _ = _test_mode_opt(
                tmp, f"BD6_{gpu_ids}", {"type": "BD", "sigma": 1.5},
                {"gt_seq_dir": f"{tmp}/BD6/GT"}, f"{tmp}/ckpt/G_iter1.npz",
                {"PSNR": {"colorspace": "y"}})
            _, secs, _ = _cli(exp, yml, gpu_ids)
            d = f"{exp}/results/Vid4/G_iter1/foliage"
            outs[gpu_ids] = np.stack([read_png(f"{d}/{n}")
                                      for n in sorted(os.listdir(d))])
            where = "the card" if gpu_ids == "0" else "the CPU"
            print(f"test mode BD6 on {where}: {TM_CPU_FRAMES} frames in "
                  f"{secs:.2f} s (host clock)")
        diff = outs["0"].astype(np.int32) - outs["-1"]
        mse = float(np.mean(diff.astype(np.float64) ** 2))
        psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
        ok = (outs["0"].shape == (TM_CPU_FRAMES, *TM_GT, 3)
              and np.abs(diff).max() <= F32_MAX_DIFF and psnr > F32_PSNR)
        print(f"test mode card vs CPU (fp32, {TM_CPU_FRAMES} frames of "
              f"{TM_GT[0]}x{TM_GT[1]}): max diff {np.abs(diff).max()} (<= "
              f"{F32_MAX_DIFF}), PSNR {psnr:.2f} dB (> {F32_PSNR}): "
              f"{'ok' if ok else 'FAIL'}")
        _require(ok, "test mode: card output outside the CPU's fp32 band")
        sd = load_generator_params(f"{tmp}/ckpt/G_iter1.npz", NB, SCALE)

    # (g) bf16 against fp32 over a 96-frame clip, full width, on the card
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = FRNet.from_state_dict(FRNetConfig(nf=NF, nb=NB, scale=SCALE), sd,
                                "cuda")
    lr = torch.from_numpy(_smooth_frames(rng, DRIFT_T, *DRIFT_LR)).cuda()
    a, b = (infer_sequence(net, lr, FRNetConfig(
        nf=NF, nb=NB, scale=SCALE, compute_dtype=dt), chunk=16)
        .cpu().numpy().astype(np.float64) for dt in ("float32", "bfloat16"))
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
    mse = np.mean((a - b) ** 2, axis=(1, 2, 3))
    psnr = 10 * np.log10(255.0 ** 2 / np.maximum(mse, 1e-12))
    first, last = psnr[:16].mean(), psnr[-16:].mean()
    ok = psnr.min() > DRIFT_FLOOR and last > first - DRIFT_SLIDE
    print(f"bf16 drift over {DRIFT_T} frames of {DRIFT_LR[0]}x{DRIFT_LR[1]} "
          f"(nf={NF}, nb={NB}, {SCALE}x BD, against fp32 on the card): "
          f"worst frame {psnr.min():.2f} dB (> {DRIFT_FLOOR}), first 16 "
          f"{first:.2f}, last 16 {last:.2f} dB (> first - {DRIFT_SLIDE}): "
          f"{'ok' if ok else 'FAIL'} on {card}")
    _require(ok, "bf16 drift bound violated")
    _determinism(net, torch.from_numpy(_smooth_frames(
        rng, TM_FRAMES + 5, TM_GT[0] // SCALE, TM_GT[1] // SCALE)).cuda(),
        card)


def _determinism(net, lr, card):
    """Test mode's fp32 inference (TF32 off) with cuDNN's deterministic
    algorithms, as the CLI runs it, against cuDNN's default choice, in
    turns: the time of each and whether repeated runs agree. The
    deterministic runs must be bit-identical."""
    import torch

    from tecogan_tpu_torch.models.base import inference_numerics
    from tecogan_tpu_torch.models.networks import FRNetConfig, infer_sequence

    cfg = FRNetConfig(nf=NF, nb=NB, scale=SCALE)
    outs, times = {True: [], False: []}, {True: [], False: []}
    with inference_numerics("float32"):
        for det in (True, False) + (True, False, False, True) * 2:
            torch.backends.cudnn.deterministic = det
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[det].append(infer_sequence(net, lr, cfg, chunk=16)
                             .cpu().numpy())
            times[det].append(time.perf_counter() - t0)
    differ = {det: [int((o != v[0]).sum()) for o in v[1:]]
              for det, v in outs.items()}
    t = len(lr)
    print(f"test mode fp32 inference, {t} frames of {tuple(lr.shape[1:3])} "
          f"LR, TF32 off, in turns after a warm-up each: cuDNN "
          f"deterministic {min(times[True][1:]) * 1e3:.1f} ms (all "
          f"{[round(x * 1e3, 1) for x in times[True][1:]]}), default "
          f"{min(times[False][1:]) * 1e3:.1f} ms (all "
          f"{[round(x * 1e3, 1) for x in times[False][1:]]}); values "
          f"differing from the first run: deterministic {differ[True]}, "
          f"default {differ[False]} on {card}")
    _require(not any(differ[True]),
             "deterministic fp32 inference differs between runs")


def phase_fps(model, card, variants, streams=1):
    """bench.py's protocol for each variant (label, cfg, fold_streams): 64
    frames of 134x320 per stream, bf16, chunk=64, a checksum read back to
    force the sync; one warm-up each, then five rounds with the variants in
    turns (the order reversed every other round), min of 5. Returns
    {label: frames/s over all streams}."""
    import torch

    from tecogan_tpu_torch.models.networks import infer_sequence_batch

    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    lr = torch.rand((streams, 64, 134, 320, 3), generator=gen,
                    device=model.device)

    def run(x, cfg, fold):
        return int(infer_sequence_batch(model.net_g, x, cfg, chunk=64,
                                        fold_streams=fold)
                   .sum(dtype=torch.int64).item())

    for _, cfg, fold in variants:
        run(lr, cfg, fold)
    times = {label: [] for label, _, _ in variants}
    for rep in range(5):
        x = lr + (rep + 1) * 1e-6
        for label, cfg, fold in (variants if rep % 2 == 0
                                 else variants[::-1]):
            t0 = time.perf_counter()
            run(x, cfg, fold)
            times[label].append(time.perf_counter() - t0)
    fps = {}
    for label, ts in times.items():
        fps[label] = streams * 64 / min(ts)
        print(f"FPS ({label}) {streams}x64x134x320 4x BD nf=64 nb=10 bf16 "
              f"chunk=64: {fps[label]:.2f} frames/s over {streams} "
              f"stream(s) (min of 5: {min(ts) * 1e3:.1f} ms; all "
              f"{[round(t * 1e3, 1) for t in ts]}) on {card}")
    return fps


def _kernel_counters():
    from tecogan_tpu_torch.ops.warp_cuda import warp_planes, warp_rgb
    from tecogan_tpu_torch.ops.warp_phases import warp_phases
    from tecogan_tpu_torch.ops.warp_vjp import warp_dflow, warp_dimage

    return {"K1": warp_planes, "K2": warp_rgb, "K3": warp_dimage,
            "K4": warp_dflow, "K5": warp_phases}


def _reset_counts():
    """Set every kernel's launch count to 0."""
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    counters["K1"].band_launches = 0
    counters["K3"].dflow_launches = 0


def _read_counts():
    """Every kernel's launch count; "K1 band" counts K1's band-mode
    launches, which "K1" includes, and "K3+K4" K3's launches that also
    computed the flow adjoint, which "K3" includes ("K4" counts K4's own
    launches)."""
    counters = _kernel_counters()
    return {**{k: c.launches for k, c in counters.items()},
            "K1 band": counters["K1"].band_launches,
            "K3+K4": counters["K3"].dflow_launches}


def _uint8_diff(a, b):
    """(max |a - b|, share of values that differ) of two uint8 tensors."""
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def phase_p16(model, card, rng):
    """The packed16 path at full width through infer_sequence_batch, 64
    frames of 134x320 in one chunk: K5 once per warped frame and no other
    kernel; the output against the card's default path, same weights and
    frames; the FPS of both paths, in turns; a profile. Returns K5's
    launch count."""
    import dataclasses

    import torch

    from tecogan_tpu_torch.models.networks import infer_sequence_batch
    from tecogan_tpu_torch.models.networks.frnet import _phase_flow_coords

    cfg = dataclasses.replace(model.cfg_g, packed16=True)
    lr = torch.from_numpy(_smooth_frames(rng, 64, 134, 320))[None].to(
        model.device)
    torch.cuda.synchronize()
    _reset_counts()
    got = infer_sequence_batch(model.net_g, lr, cfg, chunk=64)
    torch.cuda.synchronize()
    counts = _read_counts()
    print(f"packed16 path launches (64 frames warped): {counts}")
    _require(counts == {**dict.fromkeys(counts, 0), "K5": 64},
             "the packed16 path did not launch K5, and only K5, once per "
             "warped frame")
    _require(got.shape == (1, 64, 536, 1280, 3) and got.dtype == torch.uint8,
             f"packed16 output {got.dtype} {tuple(got.shape)}")
    ref = infer_sequence_batch(model.net_g, lr, model.cfg_g, chunk=64)
    max_d, frac = _uint8_diff(got, ref)
    ok = max_d <= P16_MAX_DIFF and frac < P16_FRAC
    print(f"card bf16 packed16 vs card bf16 default path (64 moving frames "
          f"of 134x320): max diff {max_d} (<= {P16_MAX_DIFF}), pixels "
          f"differing {frac:.5f} (< {P16_FRAC}): {'ok' if ok else 'FAIL'}")
    _require(ok, "packed16 output outside its band")
    phase_fps(model, card, [("default", model.cfg_g, False),
                            ("packed16", cfg, False)])
    # each path's warp input made from one chunk's LR flow: the bf16 HR
    # flow, or the f32 per-phase coordinates
    with torch.inference_mode():
        x = lr[0].permute(0, 3, 1, 2).to(cfg.dtype)
        lr_flow = model.net_g.fnet(x, torch.cat([torch.zeros_like(x[:1]),
                                                 x[:-1]]))
        for label, fn in (
                ("HR flow (default)",
                 lambda: model.net_g.hr_flow(lr_flow, 134, 320)),
                ("per-phase f32 coordinates (packed16)",
                 lambda: _phase_flow_coords(cfg, lr_flow, 134, 320))):
            fn()
            print(f"{label} from a 64-frame chunk's LR flow: "
                  f"{_cuda_ms(fn, 10):.3f} ms (CUDA events) on {card}")
    x = torch.rand((1, 64, 134, 320, 3), device=model.device)
    _profile(lambda: infer_sequence_batch(model.net_g, x, cfg, chunk=64),
             "packed16, 64 frames", card, ("warp_phases_kernel",))
    return counts["K5"]


def phase_fold(model, card, rng):
    """The fold_streams path at full width through infer_sequence_batch,
    4 streams of 64 frames of 134x320 in one chunk: band-mode K1 once per
    frame and no other kernel; each stream against the unfolded batched
    path; aggregate FPS beside the unfolded path's; a profile. Returns
    band-mode K1's launch count."""
    import torch

    from tecogan_tpu_torch.models.networks import infer_sequence_batch

    lr = torch.from_numpy(np.stack([_smooth_frames(rng, 64, 134, 320)
                                    for _ in range(FOLD_STREAMS)])).to(
        model.device)
    torch.cuda.synchronize()
    _reset_counts()
    got = infer_sequence_batch(model.net_g, lr, model.cfg_g, chunk=64,
                               fold_streams=True)
    torch.cuda.synchronize()
    counts = _read_counts()
    print(f"fold_streams path launches ({FOLD_STREAMS} streams x 64 "
          f"frames): {counts}")
    _require(counts == {**dict.fromkeys(counts, 0), "K1": 64,
                        "K1 band": 64},
             "the fold path did not launch band-mode K1, and only it, once "
             "per frame")
    _require(got.shape == (FOLD_STREAMS, 64, 536, 1280, 3)
             and got.dtype == torch.uint8,
             f"fold output {got.dtype} {tuple(got.shape)}")
    ref = infer_sequence_batch(model.net_g, lr, model.cfg_g, chunk=64)
    diffs = [_uint8_diff(got[b], ref[b]) for b in range(FOLD_STREAMS)]
    ok = all(m <= FOLD_MAX_DIFF and f < FOLD_FRAC for m, f in diffs)
    print(f"card bf16 folded vs card bf16 unfolded batched path, per stream "
          f"(max diff, pixels differing): {diffs} (<= {FOLD_MAX_DIFF}, < "
          f"{FOLD_FRAC}): {'ok' if ok else 'FAIL'}")
    _require(ok, "fold_streams output outside its band")
    phase_fps(model, card, [("fold_streams", model.cfg_g, True),
                            ("unfolded batch", model.cfg_g, False)],
              streams=FOLD_STREAMS)
    x = torch.rand((FOLD_STREAMS, 64, 134, 320, 3), device=model.device)
    _profile(lambda: infer_sequence_batch(model.net_g, x, model.cfg_g,
                                          chunk=64, fold_streams=True),
             f"fold_streams, {FOLD_STREAMS}x64 frames", card,
             ("warp_planes_kernel",))
    return counts["K1 band"]


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
    """The default and the packed16 path on the card, fp32 (TF32 off) and
    bf16, each against the same path in fp32 on the CPU (its plain
    versions), same weights and inputs."""
    import torch

    from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                   infer_sequence)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card vs CPU: TF32 off for cuDNN convolutions and matmuls")
    lr = torch.from_numpy(_smooth_frames(rng, 8, 64, 64))
    cpu_net = FRNet.from_state_dict(FRNetConfig(nf=NF, nb=NB, scale=SCALE),
                                    sd, "cpu")
    net = FRNet.from_state_dict(FRNetConfig(nf=NF, nb=NB, scale=SCALE), sd,
                                "cuda")
    for packed16 in (False, True):
        cfg32 = FRNetConfig(nf=NF, nb=NB, scale=SCALE, packed16=packed16)
        cfg16 = FRNetConfig(nf=NF, nb=NB, scale=SCALE, packed16=packed16,
                            compute_dtype="bfloat16")
        cpu = infer_sequence(cpu_net, lr, cfg32,
                             chunk=4).numpy().astype(np.int32)
        for cfg, max_diff, floor in ((cfg32, F32_MAX_DIFF, F32_PSNR),
                                     (cfg16, BF16_MAX_DIFF, BF16_PSNR)):
            got = infer_sequence(net, lr.cuda(), cfg, chunk=4).cpu().numpy()
            d = got.astype(np.int32) - cpu
            mse = float(np.mean(d.astype(np.float64) ** 2))
            psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
            ok = np.abs(d).max() <= max_diff and psnr > floor
            path = "packed16" if packed16 else "default"
            print(f"card {cfg.compute_dtype} vs CPU float32, {path} path "
                  f"(8x64x64, nf=64, nb=10): max diff {np.abs(d).max()} (<= "
                  f"{max_diff}), PSNR {psnr:.2f} dB (> {floor}): "
                  f"{'ok' if ok else 'FAIL'}")
            _require(ok, f"card {cfg.compute_dtype} {path} output outside "
                     f"its band")


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
    (every HR warp but frame 0's zero carry; not the loss's LR data), each
    fused with K4 since its flow needs one too; K4 alone for the loss's
    warp, whose flow alone needs a gradient (frame 0's zero flow needs
    none)."""
    return {"K2": t + 1 + (t if remat else 0), "K3": t - 1, "K3+K4": t - 1,
            "K4": 1}


def phase_train(rng, card):
    """Five full-width training steps through VSRModel.train. Returns the
    K2/K3/K4 launch counts of that run (and the K3 launches fused with
    K4)."""
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
        _reset_counts()
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
        launches = _read_counts()
        per_step = _expected_launches(TRAIN_T, cfg.remat)
        expected = {**dict.fromkeys(launches, 0),
                    **{k: TRAIN_STEPS * v for k, v in per_step.items()}}
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
                 ("warp_planes_kernel", "warp_dimage_kernel",
                  "warp_dimage_dflow_kernel", "warp_dflow_kernel"))

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
    return {k: launches[k] for k in ("K2", "K3", "K3+K4", "K4")}


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
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # the mangled kernel name from its name to its template arguments
            kernel = line.split("'")[1]
            k = kernel.find("_kernelI")
            kernel = kernel[kernel.rfind("warp_", 0, k):kernel.find("EEv") + 1]
        elif any(k in line for k in ("registers", "spill", "error")):
            print(f"  ptxas: {kernel}: {line.strip()}")

    times = {"K1": phase_k1(card), "K1 band": phase_k1_band(card),
             "K5": phase_k5(card)}

    rng = np.random.default_rng(SEED)
    params = _jax_layout_params(rng, NF, NB, SCALE)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "G_random.npz")
        save_pytree(params, ckpt)
        model, k1_launches = phase_slice(ckpt, rng)
    phase_test_mode(card)
    phase_profile(model, card)
    launches = {"K1": k1_launches, "K5": phase_p16(model, card, rng),
                "K1 band": phase_fold(model, card, rng)}
    del model
    sd = state_dict_from_jax(params, NB, SCALE)
    phase_card_vs_cpu(sd, rng)

    times.update(phase_k234(card))
    launches.update(phase_train(rng, card))
    phase_train_card_vs_cpu(sd, rng)

    _require("jax" not in sys.modules and "yaml" not in sys.modules,
             "jax or yaml was imported")
    rows = []
    for key, name, source, replaces in (
            ("K1", "warp_planes", "tecogan_tpu_torch/csrc/warp_planes.cu",
             "tecogan_tpu/ops/warp_pallas.py:153"),
            ("K1 band", "warp_planes_band",
             "tecogan_tpu_torch/csrc/warp_planes.cu",
             "tecogan_tpu/ops/warp_pallas.py:153"),
            ("K2", "warp_rgb", "tecogan_tpu_torch/csrc/warp_planes.cu",
             "tecogan_tpu/ops/warp_pallas.py:473"),
            ("K3", "warp_dimage", "tecogan_tpu_torch/csrc/warp_vjp.cu",
             "tecogan_tpu/ops/warp_vjp.py:156"),
            ("K4", "warp_dflow", "tecogan_tpu_torch/csrc/warp_vjp.cu",
             "tecogan_tpu/ops/warp_vjp.py:288"),
            ("K3+K4", "warp_dimage_dflow",
             "tecogan_tpu_torch/csrc/warp_vjp.cu",
             "tecogan_tpu/ops/warp_vjp.py:156, "
             "tecogan_tpu/ops/warp_vjp.py:288"),
            ("K5", "warp_phases", "tecogan_tpu_torch/csrc/warp_phases.cu",
             "tecogan_tpu/ops/warp_pallas.py:324")):
        t = times[key]
        _require(launches[key] > 0, f"{name} was not launched on its path")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}})
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
