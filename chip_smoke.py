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
   controls; then K2 and K3 alone at the STNet assembly's shape
   (24,3,128,128), bit for bit, K3's grid passes, and K3 alone timed there;
10. the training path: a VSRModel built like the Vimeo FRVSR train.yml
   (nf=64, nb=10, 4x BD, batch 2 x 10 frames of 136^2 uint8 GT, bf16 mixed
   precision, remat) takes five steps; the K2/K3/K4 launch counts (and the
   K3 launches fused with K4) must be exactly what the step's structure
   gives; ms/step, a profile of one step; fp32 ms/step with TF32 off (as
   the step sets it) and under PyTorch's default (cuDNN TF32 on), in
   turns; then save and resume into a fresh model;
11. one training step on the card against the CPU, fp32 and bf16, each
   under the settings the step sets itself (fp32: TF32 off), with the
   setting its convolutions saw printed;
12. TecoGAN training: a VSRGANModel on the shipped TecoGAN train.yml (read
   with the port's YAML reader; a generator made from the seed, VGG19 with
   random weights behind its allow_random_weights gate) takes five
   full-width steps (nf=64, nb=10, 4x BD, batch 2 x 10 frames of 136^2
   uint8 GT, 19 after ping-pong, STNet at 128^2, bf16, remat, the adaptive
   vote): the K2/K3/K3+K4/K4 launch counts of its structure, every G weight
   moved, D's exactly on the steps whose vote passed, n_upd_D their count,
   VGG19 unchanged, finite logs; a step whose vote is forced to fail leaves
   D's weights and Adam state bit-identical; ms/step (also with
   update_policy always, which reads nothing back), peak memory, a profile
   and a breakdown of one step; fp32 ms/step with TF32 off and on, and
   with D's forwards under cuDNN, in turns, as in phase 10; save and
   resume;
13. one GAN step on the card against the CPU, fp32 and bf16, as in
   phase 11, and the fp32 D phase against float64 on the step's D inputs
   and on d_band.py's; every fp32 D convolution forward from float64, no
   bf16 one;
14. train mode through the port's CLI (tecogan_tpu_torch.main, in process,
   card 0), from a records store of 4 sequences x 30 frames at REDS's
   frame geometry (720x1280) made from the seed and a 10-frame PNG
   validation sequence: the shipped FRVSR REDS train.yml at full width
   (nf=64, nb=10, batch 2 x 10 frames of 128^2, bf16, remat, 3 loader
   workers) for 12 iterations (checkpoints at 5, 10 and 12, validation at
   6 and 12, one JAX-format log line an iteration, the native assembler,
   K2/K3+K4/K4 12 x the step's structure, K1 once per frame warped in the
   validations), resumed to 15 (iterations 13-15 only), then a run with
   nothing left; the loop's ms/iteration against model.train alone on the
   same batches, the device idle share over 3 loop iterations, the host
   loader's batches/s with the native and the numpy assembler; the
   device-resident loader bit for bit the host loader's on the card (BD,
   and BI from a paired store of 2 x 12 frames with imresize_matlab LR)
   and its loop time; 3 iterations of the shipped BI FRVSR train.yml; 4
   of the shipped TecoGAN REDS train.yml (D_iter4.npz, lr_D, K3 alone
   once an iteration).
15. serving: three artifacts of the flagship generator (bf16, fp32, bf16
   packed16; 1 x 64 frames of 134x320, chunk 16, bench.py's geometry)
   exported by tools/export_serving.py and reloaded by
   serving.load_artifact, each bit-identical to infer_sequence_batch, K1
   (K5 for packed16) once per warped frame and no other kernel, with the
   export and load seconds and the files' bytes; serve.main in process on
   2 PNG sequences of 40 frames (plain, with --pad_front 5, with a --ckpt
   override), every PNG equal to the live frames, and a 50-frame sequence
   refused by a 48-frame artifact; the loaded bf16 program's FPS against
   the live path in turns at bench.py's protocol, a profile of each, and
   K1's host cost through its operator against a direct launch;
16. profile mode through the CLI in process on the shipped FRVSR Vimeo
   train.yml at 3x134x320 with --test_speed: 94.438 analytic GFLOPs
   (FNet 10.511, SRNet 83.927; 2589093 parameters), the FlopCounterMode
   count, the FPS, K1 once per step; with TECOGAN_TRACE_DIR, a chrome
   trace holding K1's events;
17. LPIPS with weights made from the seed: the card against the CPU on
   576x720 pairs (AlexNet distance and spatial map, VGG16, SqueezeNet),
   rtol 1e-4; test mode through the CLI with LPIPS in the metric stack
   (phase 5's BD set), against a CPU recomputation from the PNGs; the
   official harness (official_metrics.evaluate) on those PNGs with LPIPS
   and tLP100, its LPIPS column equal to the metric calculator's; host
   and device seconds a frame of LPIPS beside PSNR's and SSIM's.
18. K1's window mode (row-sharded inference's warp of a slab of a taller
   image, clamped at the global border) against its plain version, bit for
   bit, at the sharded path's geometry (LR 512x960 at 4x, 4 shards: both
   border shards and an interior one; f32/bf16 planes and flow; smooth and
   i.i.d. flow), and on the degenerate window against K1; timed (run with
   the kernels after phase 3);
19. row-sharded inference (infer_sequence_sp) at full width, 8 frames of
   512x960 to 4K in one chunk on 2 and 4 shards of the one card, against
   the unsharded infer_sequence: fp32 within 1 gray level on <=0.02% of
   pixels, bf16 in the same band; K1's window mode once
   per shard and frame; the FPS of each in turns with the device idle
   share (on one card sharding only adds halo work);
20. data parallelism: 2 ranks spawned on the one card with torchrun's
   environment over gloo, its collectives on CUDA tensors; the Vimeo FRVSR
   train.yml geometry for 3 bf16 steps and one fp32 step, one fp32 TecoGAN
   step on the shipped train.yml under the adaptive vote (D's lr 0):
   identical rank logs, weights and gradients, the fp32 two-rank step
   equal to one rank's at the doubled batch (losses, gradients, G's Adam
   updates, D's BatchNorm running stats, the vote), the launches per rank
   those of the structure, the bf16 step time of the two ranks sharing the
   card beside one process at the global batch; then the CLI's --mode
   train for 2 iterations at world size 1 over NCCL.
21. the bench entry: ``python3 bench_torch.py`` in a subprocess, as a user
   runs it (bench.py's protocol on the card: its JSON line with the four
   keys and the port's metric name, a finite FPS > 0, K1 once per warped
   frame of its 6 runs), then the perf canary
   (``tools/bench_suite.check_canary``) in process against
   ``tools/perf_canary.json``: bf16 4x BD FPS and FRVSR and TecoGAN
   ms/step at the reference batch geometry, each inside its band; K1, K2,
   K3+K4 and K4 launched by it.
22. the synthetic campaign (tools/run_synth_campaign.py) through its stage
   functions, each CLI a subprocess on the card, at full width (nf=64,
   nb=10, crop 128, batch 4, tempo 10, bf16) with depth cut: 8 training
   clips of 16 frames at 192^2 and 2 held-out sequences of 10 frames at
   256x448 made from the seed, FRVSR for 16 iterations, TecoGAN
   warm-started from it for 8 (every iteration logged), then the eval
   (the bicubic baseline on the card, test mode of both models, the
   official harness): every stage's checkpoints and summary.json with its
   three rows, the harness's frame counts 2 x (10 - 4) and 2 x (10 - 5)
   for tOF, every logged loss finite, each CLI's kernel launches (the
   line it logs at its end) equal to its structure; before it, bit for
   bit their plain versions: K1 at the eval's fp32 (1,3,256,448), K2 and
   K3+K4 at the batch of 4 (4,3,128,128), K3 alone at TecoGAN's fake
   STNet assembly (48,3,128,128), K2 and K4 alone at the warping loss's
   (36,3,32,32) and (72,3,32,32); on a failure, the stages' output; after it
   infer_streams on [0, 0] (4 streams of 16 frames at 134x320, bf16) bit
   for bit infer_sequence_batch, K1 once per block and frame.
23. (run after phase 13) every fp32 convolution and linear pass of one
   FRVSR step at phase 10's geometry and of one GAN step on d_band.py's
   case (G, D and VGG19): forward, input gradient and weight gradient, each
   recomputed on the CPU in float64 and fp32 from the card's own operands;
   the card's relative L2 distance from float64 within 4x the CPU fp32's
   or a floor (tools/conv_audit.py), D's convolution forwards within one
   fp32 rounding of float64 and every one of them from float64; a control
   GAN step with D's forwards under cuDNN, whose block-1 forward must fall
   outside one rounding; then, printed only, D's LeakyReLU inputs on that
   case's other side of the kink from float64's, with cuDNN's fp32
   forwards and with the forwards from float64 that fp32 steps run.

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
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from tecogan_tpu_torch.ops import kernel_launches, reset_kernel_launches

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
# K1's call in train mode's validation: one REDS HR frame (720x1280)
VAL_SHAPE = (1, 3, 720, 1280)
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
    # train mode's validation call: a REDS frame (720x1280), the frame view
    # of a chunk's HR flows and the NCHW layout, every dtype pairing; held
    # bit for bit (VAL_SHAPE below)
    for pd in dts:
        for fd in dts:
            for layout in ("nchw", "chunk"):
                for sigma in (6.0, 30.0, 300.0):
                    cases.append((VAL_SHAPE, pd, fd, layout, sigma))
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
        if shape == VAL_SHAPE:
            ok = torch.equal(got, ref)
            detail = f"max_abs_err={err:.3g} (bit for bit required)"
        elif pd == "f32":
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
    # validation's call in train mode (bf16 planes, the bf16 chunk view of
    # a smooth HR flow at 720x1280): timed and printed
    vn, vc, vh, vw = VAL_SHAPE
    v_planes = torch.randn(VAL_SHAPE, generator=gen, device=dev).bfloat16()
    v_flow = torch.stack([_smooth_flow(gen, dev, vn, vh, vw, 6.0)] * 2,
                         1).bfloat16()[:, 1].permute(0, 2, 3, 1)
    v_grid = _grid(v_flow, v_planes.dtype)
    v_out = warp_planes(v_planes, v_flow)
    _time_kernel(
        f"K1 time {VAL_SHAPE} bf16 planes+flow (train mode's validation, a "
        f"chunk's frame view), smooth flow sigma 6", card,
        lambda: warp_planes(v_planes, v_flow),
        lambda: warp_planes_reference(v_planes, v_flow),
        lambda: F.grid_sample(v_planes, v_grid, mode="bilinear",
                              padding_mode="border", align_corners=True),
        _bound("K1", (v_planes, v_flow), (v_out,), v_out[:, 0].numel(), vc))
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
                     f"{name} is not one kernel launch a call at {shape}: "
                     f"the profiler saw {names}")
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


def _kernel_names(fn, iters=20, tries=3):
    """{device kernel name: launches} over ``iters`` calls of ``fn``, from
    torch.profiler (which may drop a launch, never add one). The profiler
    now and then records no device event at all (as ``_device_ms`` finds):
    then it profiles again, ``tries`` times in all, and gives {}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count}
        if names:
            return names
        print(f"profiler: no device event in {iters} calls "
              f"(try {attempt + 1} of {tries})")
    return {}


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
    reset_kernel_launches()
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
    counts = kernel_launches()
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


def _shipped(path):
    """A YAML of the repo (a shipped experiment config), read by the port's
    reader."""
    from tecogan_tpu_torch.utils.yaml_subset import safe_load

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           path)) as f:
        return safe_load(f.read())


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
    from tecogan_tpu_torch.utils.yaml_subset import safe_dump

    opt = _shipped(SHIPPED_TEST_YML)
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
        f.write(safe_dump(opt))
    return exp, path, opt["test"]["num_pad_front"]


class _LogLines:
    """Collects the messages of the port's 'base' logger at ``level`` and
    up."""

    def __init__(self, level="INFO"):
        self.level = level

    def __enter__(self):
        import logging

        from tecogan_tpu_torch.utils.logging_utils import setup_logger

        self.lines = []
        self.handler = logging.Handler(self.level)
        self.handler.emit = lambda r: self.lines.append(r.getMessage())
        setup_logger("base").addHandler(self.handler)
        return self.lines

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

    with _LogLines("WARNING") as warns:
        t0 = time.perf_counter()
        records = cli_main(["--exp_dir", exp, "--mode", "test", "--opt", yml,
                            "--gpu_ids", gpu_ids])
        secs = time.perf_counter() - t0
    return records, secs, list(warns)


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
    from tecogan_tpu_torch.nn import no_tf32
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
            reset_kernel_launches()
            with _blocked(block):
                records, secs, warns = _cli(exp, yml, "0")
            counts = kernel_launches()
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
    net = FRNet.from_state_dict(FRNetConfig(nf=NF, nb=NB, scale=SCALE), sd,
                                "cuda")
    lr = torch.from_numpy(_smooth_frames(rng, DRIFT_T, *DRIFT_LR)).cuda()
    with no_tf32():
        a, b = (infer_sequence(net, lr, FRNetConfig(
            nf=NF, nb=NB, scale=SCALE, compute_dtype=dt), chunk=16)
            .cpu().numpy().astype(np.float64)
            for dt in ("float32", "bfloat16"))
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
    reset_kernel_launches()
    got = infer_sequence_batch(model.net_g, lr, cfg, chunk=64)
    torch.cuda.synchronize()
    counts = kernel_launches()
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
    reset_kernel_launches()
    got = infer_sequence_batch(model.net_g, lr, model.cfg_g, chunk=64,
                               fold_streams=True)
    torch.cuda.synchronize()
    counts = kernel_launches()
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
    from tecogan_tpu_torch.nn import no_tf32

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
            with no_tf32():
                got = infer_sequence(net, lr.cuda(), cfg,
                                     chunk=4).cpu().numpy()
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
        reset_kernel_launches()
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
        launches = kernel_launches()
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
        opt32 = _train_opt(ckpt_dir)
        opt32["train"]["mixed_precision"] = False
        model32 = VSRModel(opt32)
        _fp32_tf32_turns(
            f"FRVSR (nf={NF}, nb={NB}, batch {TRAIN_BATCH}x{TRAIN_T}x"
            f"{size}^2, remat)", model32,
            [model32.prepare_training_data({"gt": gt})
             for gt in batches[:TF32_TURN_STEPS]], card)
        del model32

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


@contextlib.contextmanager
def _tf32_seen(nets):
    """Record, at every forward of the first convolution of each of
    ``nets``, whether cuDNN may run fp32 convolutions in TF32
    (``torch.backends.cudnn.allow_tf32``); yields the list it fills."""
    import torch

    seen = []
    hooks = [next(m for m in net.modules() if isinstance(m, torch.nn.Conv2d))
             .register_forward_pre_hook(
                 lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
             for net in nets]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def _check_tf32_seen(label, seen, mixed):
    """Print the TF32 setting a step's convolutions saw and the one around
    the step; an fp32 step must have run them all with TF32 off."""
    import torch

    print(f"{label}: cudnn.allow_tf32 at its convolutions {sorted(set(seen))}"
          f" ({len(seen)} forwards), around the step "
          f"{torch.backends.cudnn.allow_tf32}")
    _require(seen and (mixed or not any(seen)),
             f"{label}: an fp32 step ran a convolution with TF32 on")


# fp32 ms/step with TF32 off (the step's own settings) against PyTorch's
# defaults (cuDNN TF32 on, CUDA matmuls off: what an fp32 step ran under
# before it set its own) and, for TecoGAN, against the step with D's
# forwards under cuDNN (as before they came from float64), in turns,
# TF32_TURN_STEPS timed steps a turn
TF32_TURNS = ("off", "on", "on", "off")
GAN_TURNS = ("off", "on", "cuDNN D", "cuDNN D", "on", "off")
TF32_TURN_STEPS = 2
_TURN_NAMES = {"off": "TF32 off", "on": "on (cuDNN's default)",
               "cuDNN D": "TF32 off, D's forwards under cuDNN"}


def _fp32_tf32_turns(label, model, batches, card):
    """``model`` (an fp32 trainer) timed by CUDA events over
    ``model.train`` with TF32 off and under PyTorch's default settings,
    and for a GAN trainer with D's forwards under cuDNN
    (``_cudnn_forwards``), in TF32_TURNS (GAN_TURNS) of TF32_TURN_STEPS
    steps after a warm-up step each; prints each turn's times and the min
    of each setting. D's forwards come from float64 in the step's own
    settings only."""
    import unittest.mock

    import torch

    from tecogan_tpu_torch import nn as tnn
    from tecogan_tpu_torch.models import steps

    _require(not model.tcfg.mixed_precision, f"{label}: not an fp32 model")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    _require((cudnn.allow_tf32, matmul.allow_tf32) == (True, False),
             "PyTorch's TF32 defaults are not in force around the step")
    gan = hasattr(model, "net_d")

    def run(setting, n):
        with contextlib.ExitStack() as stack:
            if setting == "on":
                # the step without its own setting: the defaults around it
                stack.enter_context(unittest.mock.patch.object(
                    steps, "training_numerics",
                    lambda mixed: contextlib.nullcontext()))
            if setting == "cuDNN D":
                stack.enter_context(_cudnn_forwards())
            seen = stack.enter_context(_tf32_seen([model.net_g]))
            calls = tnn.conv2d_f64_forward.calls
            ms = [_events_ms(lambda: model.train(b))[0]
                  for b in batches[:n]]
            calls = tnn.conv2d_f64_forward.calls - calls
        tf32 = setting == "on"
        _require(set(seen) == {tf32}, f"{label}: its convolutions saw TF32 "
                 f"{sorted(set(seen))}, expected {tf32}")
        _require((calls > 0) == (gan and setting == "off"), f"{label}, "
                 f"{setting}: {calls} D forwards from float64")
        return [round(x, 2) for x in ms]

    turns = GAN_TURNS if gan else TF32_TURNS
    times = {setting: [] for setting in turns}
    for setting in times:
        run(setting, 1)
    for setting in turns:
        times[setting].append(run(setting, TF32_TURN_STEPS))
    best = {k: min(min(t) for t in v) for k, v in times.items()}
    ratio = ", ".join(f"off/{k} {best['off'] / best[k]:.3f}"
                      for k in best if k != "off")
    print(f"{label} fp32 ms/step (CUDA events) in turns, "
          + ", ".join(f"{_TURN_NAMES[k]} {v}" for k, v in times.items())
          + "; min " + ", ".join(f"{k} {v:.2f}" for k, v in best.items())
          + f"; {ratio} on {card}")


def _one_step(sd, batch, device, mixed, recorder=None):
    """One FRVSR step on ``batch`` (phase 11's: t=3) from the state dict
    ``sd`` on ``device``, under the settings the step sets itself; inside
    ``recorder`` (a ``conv_audit.PassRecorder``) watching G when given.
    Returns (logs as floats, {name: gradient as fp32 CPU tensor}, the
    allow_tf32 values its convolutions saw)."""
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
    if recorder is not None:
        recorder.watch("g", net)
    with _tf32_seen([net]) as seen, recorder or contextlib.nullcontext():
        _, logs = steps.frvsr_train_step(
            state, {"gt": torch.from_numpy(batch).to(device)}, cfg_g=cfg,
            tcfg=tcfg, sched_g=sched)
    return ({k: float(v) for k, v in logs.items()},
            {k: p.grad.float().cpu() for k, p in net.named_parameters()},
            seen)


def phase_train_card_vs_cpu(sd, rng):
    """One training step on the card and on the CPU, same weights and
    batch (nf=64, nb=10, t=3, LR 16x16), each under the settings the step
    sets itself (an fp32 step turns TF32 off), with nothing set around
    it."""
    import torch

    batch = _gt_clips(rng, 2, 3, 16 * SCALE + 2 * int(1.5 * 3))
    cpu_logs, cpu_g, _ = _one_step(sd, batch, "cpu", mixed=False)
    for mixed in (False, True):
        logs, grads, seen = _one_step(sd, batch, "cuda", mixed=mixed)
        _check_tf32_seen(f"train step card "
                         f"{'bf16 mixed' if mixed else 'fp32'}", seen, mixed)
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
              f"fp32 (nf={NF}, nb={NB}, t=3, LR 16x16): losses "
              f"{logs} vs {cpu_logs}, max rel diff {loss_rel:.3g}; "
              f"gradient max rel L2 {rel[worst]:.3g} ({worst}), cosine "
              f"{cos:.6f} [{band}]: {'ok' if ok else 'FAIL'}")
        _require(ok, f"card {'bf16' if mixed else 'fp32'} training step "
                 f"outside its band")


# ------------------------------------------------------------------ TecoGAN

SHIPPED_GAN_TRAIN_YML = ("experiments_BD/TecoGAN/TecoGAN_VimeoTecoGAN_4xSR_2GPU/"
                         "train.yml")
GAN_STEPS = 5
# the fake STNet input's one warp call at the shipped geometry: the two end
# slots of 2 x 6 clips of 128^2 (batch 2, 19 frames after ping-pong)
ASSEMBLY_WARP_SHAPE = (24, 3, 128, 128)
# card vs CPU, one GAN step (te=3, LR 16^2, STNet at 64^2): fp32 as the
# FRVSR step (losses rtol 1e-4, each gradient rel L2 1e-3) with the raw-logit
# means and the vote's distance within 1e-4 absolute; bf16 mixed against
# fp32: the losses within 2% and G's gradient cosine >= 0.99 (the FRVSR
# step's bands), but the ping-pong loss within 15% and D's gradient cosine
# >= 0.93. Those two are set by bf16 itself: the ping-pong loss compares
# frames whose differences are at bf16's rounding of the HR frames, and D's
# gradient passes train-mode BatchNorm's backward (a projection that
# cancels most of it) in five bf16 layers. The port's CPU plain path, bf16
# against fp32 on the same inputs over four seeds, gives 5.6-8.6% and
# 0.963-0.978; its D trunk alone (bf16 against fp32) gives cosine 0.9916
# where the JAX package's gives 0.9911.
GAN_CMP_HR, GAN_CMP_TE = 64, 3
GAN_PP_BF16_RTOL, GAN_D_BF16_COS = 0.15, 0.93
# fp32: D's gradient is held against float64 instead (D's phase on the
# step's own inputs, on the CPU): train-mode BatchNorm's backward cancels
# most of it, and fp32 alone, on the CPU, leaves some BatchNorm-bias
# gradients 1% from float64 on some inputs. The card's fp32 gradient of
# each D parameter, and D's input gradient in the G phase, must be within
# 1e-3 of float64, or within 4x of the CPU fp32 one's distance from it;
# G's gradients, which take D's input gradient through the GAN loss, within
# 1e-3 or 4x the CPU fp32 input gradient's distance. D's lr is 0 in this
# comparison: Adam's
# first step is +-lr on each element, so an element whose gradient sign
# fp32 cannot fix would move the other way on the two devices, and the G
# phase, which runs against the updated D, would differ by that.
GAN_D_F32_CPU_FACTOR = 4.0


def _gan_expected_launches(t, remat):
    """Kernel launches of one TecoGAN step over t frames (after ping-pong
    doubling), from its structure: the FRVSR step's (``_expected_launches``)
    plus one K2 for each of the real and the fake STNet assembly, whose
    backward (the fake one's; its flow merge is gradient-stopped) is K3
    alone."""
    frvsr = _expected_launches(t, remat)
    return {"K2": frvsr["K2"] + 2, "K3": frvsr["K3"] + 1,
            "K3+K4": frvsr["K3+K4"], "K4": frvsr["K4"]}


def phase_assembly_warps(card):
    """K2 and K3 alone at the STNet assembly's shape: image and flow
    f32/bf16, NCHW and channels_last, sigma 6/30/300, each bit for bit its
    plain version, K3 twice the same bits; K3's cooperative grid and its
    passes; K3 alone timed in bf16 beside its bound,
    grid_sampler_2d_backward with the image-only mask and its zero-flow and
    streaming-add controls. Returns K3's numbers there."""
    import torch

    from tecogan_tpu_torch.ops.warp_cuda import (stride_grid, tile_plan,
                                                 warp_planes_reference,
                                                 warp_rgb)
    from tecogan_tpu_torch.ops.warp_vjp import (_dimage_slots,
                                                dimage_resident_blocks,
                                                warp_dimage,
                                                warp_dimage_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    shape = ASSEMBLY_WARP_SHAPE
    n, c, h, w = shape
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    n_cases = 0
    for sigma in (6.0, 30.0, 300.0):
        for xd in dts:
            for fd in dts:
                for fmt in (torch.contiguous_format, torch.channels_last):
                    x = torch.rand(shape, generator=gen, device=dev).to(
                        dts[xd]).contiguous(memory_format=fmt)
                    g = torch.randn(shape, generator=gen, device=dev).to(
                        dts[xd]).contiguous(memory_format=fmt)
                    flow = _vjp_flow(gen, dev, n, h, w, sigma).to(dts[fd])
                    tag = f"{shape} x={xd}/{fmt} flow={fd} sigma={sigma}"
                    got = warp_rgb(x, flow)
                    a = warp_dimage(g, flow, dts[xd])
                    b = warp_dimage(g, flow, dts[xd])
                    torch.cuda.synchronize()
                    _require(_equal(got, warp_planes_reference(x, flow))
                             and got.stride() == x.stride(),
                             f"K2 differs from its plain version: {tag}")
                    _require(_equal(a, b) and a.stride() == g.stride()
                             and _equal(a, warp_dimage_reference(
                                 g, flow, dts[xd])),
                             f"K3 alone differs from its plain version or "
                             f"between two launches: {tag}")
                    n_cases += 1
    print(f"K2 and K3 alone at the STNet assembly's shape {shape}: "
          f"{n_cases} cases bit for bit their plain versions (sigma "
          f"6/30/300, image and flow f32/bf16, NCHW and channels_last), two "
          f"K3 launches bit-identical in each")
    for name in ("tecogan_warp_dimage_bf16_bf16_bf16",
                 "tecogan_warp_dimage_f32_f32_f32"):
        resident = dimage_resident_blocks(name, 0, c)
        grid = stride_grid(n, c, h, w, min(resident, _dimage_slots(0)))
        tiles, _ = tile_plan(n, h, w, steps=1)
        passes = math.prod(-(-t // g) for t, g in zip(tiles, grid))
        print(f"{name} at {shape}: {resident} co-resident blocks (occupancy "
              f"query), grid {grid} over tiles {tiles}: {passes} pass(es) "
              f"of the grid-stride loop")

    x = torch.rand(shape, generator=gen, device=dev).bfloat16()
    g = torch.randn(shape, generator=gen, device=dev).bfloat16()
    flow = (torch.randn((n, h, w, 2), generator=gen, device=dev)
            * 6.0).bfloat16()
    grid = _grid(flow, x.dtype)
    t = _time_kernel(
        f"K3 alone time {shape} bf16 g+flow", card,
        lambda: warp_dimage(g, flow, torch.bfloat16),
        lambda: warp_dimage_reference(g, flow, torch.bfloat16),
        lambda: torch.ops.aten.grid_sampler_2d_backward(
            g, x, grid, 0, 1, True, [True, False]),
        _bound("K3", (g, flow), (x,), n * h * w, c))
    zero = torch.zeros_like(flow)
    _controls(f"K3 alone {shape} zero flow", card,
              lambda: warp_dimage(g, zero, torch.bfloat16),
              lambda: warp_dimage_reference(g, zero, torch.bfloat16), x)
    return {**t, "max_abs_err": 0.0}


def _gan_opt(ckpt_dir, g_path):
    """The shipped TecoGAN train.yml through the port's reader, with what
    ``--mode train --gpu_ids 0`` adds (is_train, device_ids [0]), and only
    the generator's weights, VGG19's gate and the checkpoint directory
    replaced."""
    opt = _shipped(SHIPPED_GAN_TRAIN_YML)
    opt.update(is_train=True, device_ids=[0])
    opt["model"]["generator"]["load_path"] = g_path
    opt["train"]["feature_crit"]["allow_random_weights"] = True
    opt["train"]["ckpt_dir"] = ckpt_dir
    return opt


def _events_ms(fn):
    """fn's time on the card's clock (CUDA events, synchronised), in ms,
    and its result."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _device_totals(fn):
    """One call of fn under torch.profiler: (wall ms, kernel ms, device
    events, kernel ms of the warp kernels); the kernel times are None when
    the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not rows:
        return wall, None, 0, None
    return (wall, sum(r[0] for r in rows) / 1e3, sum(r[1] for r in rows),
            sum(r[0] for r in rows if "warp_" in r[2]) / 1e3)


def _gan_breakdown(model, batch, card):
    """Where a GAN step's device time and device events go, by removing its
    parts (one profiled call each after a warm-up, update_policy always so
    D's backward runs every time): the whole step; the step without the
    perceptual loss (the difference is VGG19's); the FRVSR step over the
    same ping-pong clip (the generator's unroll, its pixel and warping
    losses and Adam). What is left is D's: the bicubic frames, the flow
    merge, the two assemblies, three trunk forwards, two backwards, the
    ping-pong loss and D's Adam. Walls (under the profiler) are printed
    too; on a host-bound step they move with the host."""
    import functools

    from tecogan_tpu_torch.models import steps

    tcfg = model.tcfg._replace(update_policy="always")
    state = dict(model.state)

    def gan(tc):
        return lambda: steps.tecogan_train_step(
            state, batch, cfg_g=model.cfg_g, cfg_d=model.cfg_d, tcfg=tc,
            sched_g=model.sched_g, sched_d=model.sched_d, vgg=model.vgg)

    clip = batch["gt"].cpu().numpy()
    doubled = np.concatenate([clip, clip[:, ::-1][:, 1:]], axis=1)
    gt_pp = model.prepare_training_data({"gt": doubled})["gt"]
    frvsr = functools.partial(
        steps.frvsr_train_step,
        steps.frvsr_init_state(model.net_g, model.state["opt_g"]),
        {"gt": gt_pp}, cfg_g=model.cfg_g, tcfg=tcfg, sched_g=model.sched_g)
    parts = {}
    for label, fn in (("whole", gan(tcfg)),
                      ("no VGG19", gan(tcfg._replace(feature_crit=None))),
                      ("generator", frvsr)):
        fn()
        parts[label] = _device_totals(fn)
    print(f"GAN step breakdown ({doubled.shape[1]} frames, update_policy "
          f"always; wall ms / kernel ms / device events): "
          + "; ".join(f"{k} {w:.1f} / {_ms(d)} / {e}"
                      for k, (w, d, e, _) in parts.items()) + f" on {card}")
    (_, whole, e_whole, warps), (_, no_vgg, e_no_vgg, _), (_, g, e_g, _) = (
        parts.values())
    if None in (whole, no_vgg, g):
        print("GAN step breakdown: no device time recorded; not measured")
        return
    for label, ms, events in (
            ("generator (FRVSR step on the clip)", g, e_g),
            ("VGG19 (whole - no VGG19)", whole - no_vgg, e_whole - e_no_vgg),
            ("D and the rest (no VGG19 - generator)", no_vgg - g,
             e_no_vgg - e_g),
            ("the warp kernels K2-K4", warps, None)):
        print(f"  {label}: {ms:.2f} ms of kernels ({ms / whole:.1%})"
              + ("" if events is None
                 else f", {events} device events "
                      f"({events / e_whole:.1%})"))


def _ms(x):
    return "not measured" if x is None else f"{x:.2f}"


def phase_gan_train(rng, card):
    """Five full-width TecoGAN steps through VSRGANModel.train on the
    shipped train.yml: launch counts, weights that moved (D's exactly on
    the steps whose vote passed), VGG19 frozen, ms/step, peak memory, a
    step whose vote is forced to fail (D's weights and Adam state
    untouched), the adaptive vote's host read against update_policy
    always, a profile and a breakdown of one step, then save and resume.
    Returns the K2/K3/K3+K4/K4 launch counts of the five steps."""
    import copy
    import functools

    import torch

    from tecogan_tpu_torch.models import VSRGANModel
    from tecogan_tpu_torch.utils.ckpt import save_pytree

    with tempfile.TemporaryDirectory() as tmp:
        g_path = os.path.join(tmp, "G_random.npz")
        save_pytree(_jax_layout_params(rng, NF, NB, SCALE), g_path)
        opt = _gan_opt(os.path.join(tmp, "ckpt"), g_path)
        model = VSRGANModel(opt)
        tcfg, cfg_g, cfg_d = model.tcfg, model.cfg_g, model.cfg_d
        te = tcfg.tempo_extent
        _require((cfg_g.nf, cfg_g.nb, cfg_g.scale, cfg_g.remat) == (
                     NF, NB, SCALE, True) and tcfg.mixed_precision
                 and type(cfg_d).__name__ == "STNetConfig"
                 and cfg_d.spatial_size == 128 and te == 10
                 and tcfg.update_policy == "adaptive"
                 and tcfg.crop_border_ratio == 0.75
                 and tcfg.pingpong_crit and tcfg.feature_crit
                 and all(p.dtype == torch.float32 for p in
                         [*model.net_g.parameters(),
                          *model.net_d.parameters()])
                 and not any(p.requires_grad
                             for p in model.vgg.parameters()),
                 "the GAN trainer is not the shipped configuration")
        n = opt["dataset"]["train"]["batch_size_per_gpu"]
        size = opt["dataset"]["train"]["crop_size"] + 2 * int(1.5 * 3)
        batches = [_gt_clips(rng, n, te, size) for _ in range(GAN_STEPS)]
        g0 = {k: v.clone() for k, v in model.net_g.state_dict().items()}
        v0 = {k: v.clone() for k, v in model.vgg.state_dict().items()}

        def d_weights():
            return {k: v.detach().clone()
                    for k, v in model.net_d.named_parameters()}

        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        times, votes = [], []
        for k, gt in enumerate(batches):
            batch = model.prepare_training_data({"gt": gt})
            before, n_before = d_weights(), float(model.state["cnt_upd_d"])
            ms, logs = _events_ms(lambda: model.train(batch))
            times.append(ms)
            vals = {key: float(v) for key, v in logs.items()}
            upd = vals["n_upd_D"] - n_before
            moved = sum(not torch.equal(before[key], v)
                        for key, v in model.net_d.named_parameters())
            print(f"GAN step {k}: "
                  + " ".join(f"{key} {v:.5f}" for key, v in vals.items())
                  + f" ({ms:.2f} ms, CUDA events)")
            _require(all(math.isfinite(v) for v in vals.values()),
                     f"GAN step {k}: non-finite logs {vals}")
            _require(upd in (0.0, 1.0)
                     and (upd == 1.0) == (vals["distance"] < np.float32(
                         tcfg.update_threshold))
                     and moved == (len(before) if upd else 0),
                     f"GAN step {k}: vote {upd} (distance "
                     f"{vals['distance']}), {moved} of {len(before)} D "
                     f"tensors moved")
            votes.append(upd == 1.0)
        launches = kernel_launches()
        t_all = 2 * te - 1
        per_step = _gan_expected_launches(t_all, cfg_g.remat)
        expected = {**dict.fromkeys(launches, 0),
                    **{key: GAN_STEPS * v for key, v in per_step.items()}}
        print(f"GAN training launches in {GAN_STEPS} steps: {launches}, "
              f"expected from the structure (t={t_all} after ping-pong, "
              f"remat): {expected}")
        _require(launches == expected, "the GAN path's kernel launch counts "
                 "differ from its structure")
        _require(float(model.state["cnt_upd_d"]) == sum(votes),
                 "n_upd_D differs from the votes that passed")
        changed = sum(not torch.equal(g0[key], v)
                      for key, v in model.net_g.state_dict().items())
        _require(changed == len(g0), f"only {changed} of {len(g0)} G "
                 f"tensors changed")
        _require(all(torch.equal(v0[key], v)
                     for key, v in model.vgg.state_dict().items()),
                 "VGG19 changed")
        print(f"GAN ms/step at full width (nf={NF}, nb={NB}, batch "
              f"{n}x{te}x{size}^2 uint8 GT, {t_all} frames after ping-pong, "
              f"STNet 128^2, VGG19, bf16, remat, adaptive vote): "
              f"{min(times[1:]):.2f} (min of steps 1-{GAN_STEPS - 1}; all "
              f"{[round(x, 2) for x in times]}), votes passed {votes}, on "
              f"{card}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

        # a vote forced to fail: D's weights and Adam state untouched
        skip = functools.partial(model._train_step, tcfg=tcfg._replace(
            update_threshold=-math.inf))
        before = d_weights()
        adam = copy.deepcopy(model.state["opt_d"].state_dict())
        n_before = float(model.state["cnt_upd_d"])
        model.state, logs = skip(model.state, batch)
        after = model.state["opt_d"].state_dict()
        same_adam = adam["param_groups"] == after["param_groups"] and all(
            torch.equal(after["state"][i][key], v)
            for i, st in adam["state"].items() for key, v in st.items())
        _require(all(torch.equal(before[key], v)
                     for key, v in model.net_d.named_parameters())
                 and same_adam and float(logs["l_gan_D"]) == 0.0
                 and float(logs["n_upd_D"]) == n_before,
                 "a skipped vote changed D or its Adam state")
        print("GAN step with the vote forced to fail: D's weights and Adam "
              "state bit-identical, l_gan_D 0, n_upd_D unchanged")

        # the adaptive vote's one host read a step, against always, in
        # turns (adaptive steps whose vote failed skip D's backward and are
        # left out)
        always = functools.partial(model._train_step, tcfg=tcfg._replace(
            update_policy="always"))
        t_adaptive, t_always = [], []
        for _ in range(4):
            n_before = float(model.state["cnt_upd_d"])
            ms, logs = _events_ms(lambda: model.train(batch))
            if float(logs["n_upd_D"]) > n_before:
                t_adaptive.append(ms)
            ms, (model.state, _) = _events_ms(
                lambda: always(model.state, batch))
            t_always.append(ms)
        print(f"GAN ms/step in turns: update_policy always (no host read) "
              f"{[round(x, 2) for x in t_always]}, adaptive (vote passed) "
              f"{[round(x, 2) for x in t_adaptive]}; min "
              f"{min(t_always):.2f} against "
              f"{min(t_adaptive) if t_adaptive else float('nan'):.2f} on "
              f"{card}")

        _profile(lambda: model.train(batch), "one GAN step", card,
                 ("warp_planes_kernel", "warp_dimage_kernel",
                  "warp_dimage_dflow_kernel", "warp_dflow_kernel"))
        _gan_breakdown(model, batch, card)
        opt32 = _gan_opt(os.path.join(tmp, "ckpt32"), g_path)
        opt32["train"]["mixed_precision"] = False
        model32 = VSRGANModel(opt32)
        _fp32_tf32_turns(
            f"TecoGAN (shipped train.yml, batch {n}x{te}x{size}^2, {t_all} "
            f"frames after ping-pong, STNet 128^2, VGG19, remat, adaptive "
            f"vote)", model32,
            [model32.prepare_training_data({"gt": gt})
             for gt in batches[:TF32_TURN_STEPS]], card)
        del model32

        step = model.state["step"]
        model.save(step)
        model.save_training_state_now(step)
        files = sorted(os.listdir(opt["train"]["ckpt_dir"]))
        _require(files == sorted([f"G_iter{step}.npz", f"D_iter{step}.npz",
                                  f"state_iter{step}.pth"]),
                 f"checkpoint files {files}")
        fresh = VSRGANModel(opt)
        state, resumed = fresh.try_resume(fresh.state)
        same = resumed and state["step"] == step and all(
            torch.equal(state[net].state_dict()[key], v)
            for net in ("g", "d")
            for key, v in model.state[net].state_dict().items())
        for name in ("opt_g", "opt_d"):
            a = model.state[name].state_dict()
            b = state[name].state_dict()
            same = same and a["param_groups"] == b["param_groups"] and all(
                torch.equal(b["state"][i][key], v)
                for i, st in a["state"].items() for key, v in st.items())
        same = same and torch.equal(state["cnt_upd_d"],
                                    model.state["cnt_upd_d"])
        _require(same, "the resumed GAN state differs")
        print(f"GAN save + resume: {files} written; a fresh model resumed "
              f"step {step} with identical G, D (BatchNorm stats included), "
              f"both Adam states and n_upd_D")
    return {key: launches[key] for key in ("K2", "K3", "K3+K4", "K4")}


def _one_gan_step(sds, batch, device, mixed, d_inputs=None, recorder=None):
    """One TecoGAN step from the state dicts ``sds`` (G, D, VGG19) on
    ``device``: the shipped losses, te=3, STNet at GAN_CMP_HR^2,
    update_policy always, D's lr 0 (its backward and Adam step run, its
    weights stay), under the settings the step sets itself. Returns (logs
    as floats, {name: gradient as fp32 CPU tensor} for G's and D's
    parameters, the allow_tf32 values G's and D's convolutions saw);
    ``d_inputs``, a list, receives the D phase's real and fake inputs;
    ``recorder`` (a ``conv_audit.PassRecorder``) watches G, D and VGG19
    through the step."""
    import unittest.mock

    import torch
    from torch.func import functional_call

    from tecogan_tpu_torch.models import schedules, steps
    from tecogan_tpu_torch.models.networks import (VGG19, DTrunk, FRNet,
                                                   FRNetConfig, STNetConfig)

    cfg = FRNetConfig(nf=NF, nb=NB, scale=SCALE)
    net = FRNet.from_state_dict(cfg, sds["g"], device)
    cfg_d = STNetConfig(spatial_size=GAN_CMP_HR)
    net_d = DTrunk.from_state_dict(cfg_d, sds["d"], device)
    vgg = VGG19.from_state_dict(sds["vgg"], device)
    tcfg = _gan_cmp_config(mixed)
    opt_g, sched_g = schedules.make_adam({"lr": 5e-5}, net.parameters())
    opt_d, sched_d = schedules.make_adam({"lr": 0.0}, net_d.parameters())
    state = steps.tecogan_init_state(net, net_d, opt_g, opt_d)
    seen = [] if d_inputs is None else d_inputs

    def recording(module, params, args):
        if module is net_d and len(seen) < 2:
            seen.append(args[0].detach().clone())
        return functional_call(module, params, args)

    if recorder is not None:
        for tag, m in (("g", net), ("d", net_d), ("vgg", vgg)):
            recorder.watch(tag, m)
    with unittest.mock.patch.object(steps, "functional_call", recording), \
            _tf32_seen([net, net_d]) as tf32, \
            recorder or contextlib.nullcontext():
        _, logs = steps.tecogan_train_step(
            state, {"gt": torch.from_numpy(batch).to(device)}, cfg_g=cfg,
            cfg_d=cfg_d, tcfg=tcfg, sched_g=sched_g, sched_d=sched_d,
            vgg=vgg)
    grads = {f"{tag}.{k}": p.grad.float().cpu()
             for tag, m in (("g", net), ("d", net_d))
             for k, p in m.named_parameters()}
    return {k: float(v) for k, v in logs.items()}, grads, tf32


def _gan_cmp_config(mixed):
    """The shipped TecoGAN losses at te=3, update_policy always."""
    from tecogan_tpu_torch.models import steps

    return steps.make_train_config(_gan_opt("", ""))._replace(
        tempo_extent=GAN_CMP_TE, update_policy="always",
        mixed_precision=mixed)


def _d_phase_grads(sd_d, x_real, x_fake, device, dtype):
    """The GAN step's D phase alone (D's loss on the real, then the fake
    input: D's gradients) and the G phase's D input gradient (the GAN loss
    of a forward on the fake input alone, with respect to that input), D
    in ``dtype``, under the settings an fp32 step sets itself; float64 CPU
    tensors, the input's under "input"."""
    import torch

    from tecogan_tpu_torch.models.losses import define_criterion
    from tecogan_tpu_torch.models.networks import DTrunk, STNetConfig
    from tecogan_tpu_torch.nn import training_numerics

    net = DTrunk.from_state_dict(STNetConfig(spatial_size=GAN_CMP_HR), sd_d,
                                 device).to(dtype)
    crit = define_criterion(_gan_cmp_config(False).gan_crit)
    with training_numerics(mixed_precision=False):
        real, _ = net(x_real.to(device, dtype))
        fake, _ = net(x_fake.to(device, dtype))
        (crit(real, True) + crit(fake, False)).backward()
        grads = {k: p.grad.double().cpu() for k, p in net.named_parameters()}
        x = x_fake.to(device, dtype).requires_grad_()
        grads["input"] = torch.autograd.grad(crit(net(x)[0], True),
                                             x)[0].double().cpu()
    return grads


def _d_phase_band(label, sd_d, x_real, x_fake):
    """The card's fp32 D phase (``_d_phase_grads``) against float64 on the
    CPU, beside the CPU's fp32, on the D inputs ``x_real``, ``x_fake``:
    every convolution forward of the card's from float64 operands
    (``_route_count``), and each gradient within STEP_F32_GRAD_REL of
    float64 or within GAN_D_F32_CPU_FACTOR x the CPU fp32's distance.
    Returns {name: (card, CPU fp32) distance}."""
    import torch

    ref = _d_phase_grads(sd_d, x_real, x_fake, "cpu", torch.float64)
    cpu32 = _d_phase_grads(sd_d, x_real, x_fake, "cpu", torch.float32)
    with _route_count() as routed:
        card = _d_phase_grads(sd_d, x_real, x_fake, "cuda", torch.float32)
    _require(routed[0] == routed[1] > 0,
             f"the card's fp32 D phase on {label}: {routed[1]} of its "
             f"{routed[0]} convolution forwards from float64")
    err = {k: (float((card[k] - v).norm() / v.norm()),
               float((cpu32[k] - v).norm() / v.norm())) for k, v in ref.items()}
    bad = [k for k, (e_card, e_cpu) in err.items()
           if e_card > max(STEP_F32_GRAD_REL, GAN_D_F32_CPU_FACTOR * e_cpu)]
    worst = max(err, key=lambda k: err[k][0])
    tag = "discriminator_block.block1.1.bias"
    print(f"GAN D phase fp32 against float64 ({label} "
          f"{tuple(x_real.shape)}, CPU float64 reference): card max rel "
          f"L2 {err[worst][0]:.3g} ({worst}; the CPU fp32's there "
          f"{err[worst][1]:.3g}), CPU fp32 max "
          f"{max(e[1] for e in err.values()):.3g}; {tag} card "
          f"{err[tag][0]:.3g}, CPU {err[tag][1]:.3g}; D's input gradient (G "
          f"phase) card {err['input'][0]:.3g}, CPU {err['input'][1]:.3g} "
          f"[each <= {STEP_F32_GRAD_REL} or <= {GAN_D_F32_CPU_FACTOR}x the "
          f"CPU fp32's]: {'ok' if not bad else 'FAIL ' + str(bad)}")
    _require(not bad, f"the card's fp32 D gradients on {label} are further "
             f"from float64 than their band")
    return err


@contextlib.contextmanager
def _route_count():
    """Yields [the forwards of ``nn.F64ForwardConv2d`` layers on fp32
    inputs, the calls of the route from float64 operands
    (``nn.conv2d_f64_forward.calls``)] inside it, filled on exit: equal in
    an fp32 step, the second 0 in a bf16 one."""
    import torch
    from torch.nn.modules.module import register_module_forward_hook

    from tecogan_tpu_torch import nn as tnn

    got = [0, 0]

    def hook(module, args, out):
        if isinstance(module, tnn.F64ForwardConv2d) and \
                args[0].dtype == torch.float32:
            got[0] += 1

    handle = register_module_forward_hook(hook)
    start = tnn.conv2d_f64_forward.calls
    try:
        yield got
    finally:
        handle.remove()
        got[1] = tnn.conv2d_f64_forward.calls - start


def _cudnn_forwards():
    """D's fp32 forwards as ``nn.Conv2d``'s inside an fp32 step: the
    route from float64 operands off, as D ran before it existed."""
    import unittest.mock

    import torch

    from tecogan_tpu_torch import nn as tnn

    return unittest.mock.patch.object(tnn.F64ForwardConv2d, "forward",
                                      torch.nn.Conv2d.forward)


def _kink_inputs(sd_d, x_real, x_fake, device, dtype=None, numerics=None):
    """The inputs of D's five LeakyReLUs (conv_in's output, each block's
    BatchNorm output) in D's two training-mode forwards on ``x_real`` and
    ``x_fake`` (D in ``dtype``, fp32 by default, under ``numerics``), as
    float64 CPU tensors: [[real, fake]] per LeakyReLU."""
    import torch

    from tecogan_tpu_torch.models.networks import DTrunk, STNetConfig

    dtype = dtype or torch.float32
    net = DTrunk.from_state_dict(STNetConfig(spatial_size=GAN_CMP_HR), sd_d,
                                 device).to(dtype)
    got, hooks = [], []
    for m in net.modules():
        if isinstance(m, torch.nn.LeakyReLU):
            got.append([])
            hooks.append(m.register_forward_pre_hook(
                lambda mod, a, box=got[-1]: box.append(
                    a[0].detach().double().cpu())))
    with torch.no_grad(), numerics or contextlib.nullcontext():
        net(x_real.to(device, dtype))
        net(x_fake.to(device, dtype))
    for h in hooks:
        h.remove()
    return got


def _kink_flips(label, got, ref):
    """Prints, per LeakyReLU of D, the inputs on the other side of its
    kink from float64's (``ref``), with their distance from the kink in
    float64; returns how many."""
    names = ("conv_in", *(f"block{i}" for i in range(1, 5)))
    out, total = [], 0
    for name, g, r in zip(names, got, ref):
        for call, (a, b) in enumerate(zip(g, r)):
            flip = (a > 0) != (b > 0)
            n = int(flip.sum())
            total += n
            if n:
                out.append(f"{name} ({('real', 'fake')[call]}): {n} at "
                           f"|y| {sorted(float(v) for v in b[flip].abs())[:4]}")
    print(f"{label}: D's LeakyReLU inputs across the kink from float64's: "
          f"{'; '.join(out) or 'none'}", flush=True)
    return total


def _d_band_case(sd):
    """The GAN case on whose D inputs the card's fp32 D gradients once
    left their band (``d_band.py``): G from ``sd`` (the state dict of the
    weights ``main`` draws first from SEED), D and VGG19 from their seeds,
    and the batch phase 13 draws when phases 8, 10, 11 and 12 alone draw
    from ``SEED``'s generator before it. Returns (the state dicts, the
    batch, [D's real and fake input] of its CPU fp32 step)."""
    import torch

    from tecogan_tpu_torch.models.networks import VGG19, DTrunk, STNetConfig

    rng = np.random.default_rng(SEED)
    _jax_layout_params(rng, NF, NB, SCALE)  # main's weights, ``sd``
    _smooth_frames(rng, 8, 64, 64)  # phase 8
    for _ in range(TRAIN_STEPS):  # phase 10
        _gt_clips(rng, TRAIN_BATCH, TRAIN_T, 128 + 2 * int(1.5 * 3))
    _gt_clips(rng, 2, 3, 16 * SCALE + 2 * int(1.5 * 3))  # phase 11
    _jax_layout_params(rng, NF, NB, SCALE)  # phase 12
    opt = _gan_opt("", "")
    n = opt["dataset"]["train"]["batch_size_per_gpu"]
    size = opt["dataset"]["train"]["crop_size"] + 2 * int(1.5 * 3)
    for _ in range(GAN_STEPS):
        _gt_clips(rng, n, opt["train"]["tempo_extent"], size)
    sds = {"g": sd,
           "d": DTrunk.random(STNetConfig(spatial_size=GAN_CMP_HR),
                              torch.Generator().manual_seed(SEED + 1))
           .state_dict(),
           "vgg": VGG19.random(torch.Generator().manual_seed(SEED + 2))
           .state_dict()}
    batch = _gt_clips(rng, 2, GAN_CMP_TE, GAN_CMP_HR + 2 * int(1.5 * 3))
    seen = []
    _one_gan_step(sds, batch, "cpu", mixed=False, d_inputs=seen)
    return sds, batch, seen


def phase_gan_card_vs_cpu(sd, rng, d_band_inputs):
    """One GAN step on the card and on the CPU, same weights and batch
    (nf=64, nb=10, te=3: 5 frames after ping-pong, LR 16x16, STNet at
    64^2, the shipped losses, update_policy always, D's lr 0), each step
    under the settings it sets itself (fp32: TF32 off), with nothing set
    around it; in fp32 D's gradients and its input gradient, on the
    step's own D inputs and on ``d_band_inputs`` (``_d_band_case``'s),
    also against float64 (D alone, under an fp32 step's settings)."""
    import torch

    from tecogan_tpu_torch.models.networks import (VGG19, DTrunk,
                                                   STNetConfig)
    sds = {"g": sd,
           "d": DTrunk.random(STNetConfig(spatial_size=GAN_CMP_HR),
                              torch.Generator().manual_seed(SEED + 1))
           .state_dict(),
           "vgg": VGG19.random(torch.Generator().manual_seed(SEED + 2))
           .state_dict()}
    batch = _gt_clips(rng, 2, GAN_CMP_TE,
                      GAN_CMP_HR + 2 * int(1.5 * 3))
    d_inputs = []
    cpu_logs, cpu_g, _ = _one_gan_step(sds, batch, "cpu", mixed=False,
                                       d_inputs=d_inputs)

    err = _d_phase_band("the step's D inputs", sds["d"], *d_inputs)
    _d_phase_band("d_band.py's D inputs", sds["d"], *d_band_inputs)
    # G's gradient through the GAN loss passes D's input gradient, so G's
    # band widens to what fp32 leaves of that one
    g_band = max(STEP_F32_GRAD_REL, GAN_D_F32_CPU_FACTOR * err["input"][1])

    losses = [k for k in cpu_logs if k.startswith("l_") and cpu_logs[k]]
    for mixed in (False, True):
        with _route_count() as routed:
            logs, grads, seen = _one_gan_step(sds, batch, "cuda",
                                              mixed=mixed)
        _check_tf32_seen(f"GAN step card "
                         f"{'bf16 mixed' if mixed else 'fp32'}", seen, mixed)
        _require(routed[1] == 0 if mixed else routed[0] == routed[1] > 0,
                 f"GAN step card {'bf16' if mixed else 'fp32'}: {routed[1]} "
                 f"convolution forwards from float64 (D's fp32 forwards: "
                 f"{routed[0]})")
        rel = {k: abs(logs[k] - cpu_logs[k]) / abs(cpu_logs[k])
               for k in losses}
        logit_err = {k: abs(logs[k] - cpu_logs[k]) for k in (
            "p_real_D", "p_fake_D", "p_fake_G", "distance")}
        grad_rel = {k: float((grads[k] - cpu_g[k]).norm() / cpu_g[k].norm())
                    for k in cpu_g}

        def cos(tag):
            # float64: an fp32 cosine over millions of terms rounds past 1
            a = torch.cat([grads[k].flatten() for k in cpu_g
                           if k.startswith(tag)]).double()
            b = torch.cat([cpu_g[k].flatten() for k in cpu_g
                           if k.startswith(tag)]).double()
            return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

        cos_g, cos_d = cos("g."), cos("d.")
        worst_g = max((k for k in grad_rel if k.startswith("g.")),
                      key=grad_rel.get)
        if mixed:
            ok = (all(v <= (GAN_PP_BF16_RTOL if k == "l_pp_G"
                            else STEP_BF16_RTOL) for k, v in rel.items())
                  and cos_g >= STEP_BF16_GRAD_COS
                  and cos_d >= GAN_D_BF16_COS)
            band = (f"losses <= {STEP_BF16_RTOL} (l_pp_G <= "
                    f"{GAN_PP_BF16_RTOL}), G cosine >= {STEP_BF16_GRAD_COS}, "
                    f"D cosine >= {GAN_D_BF16_COS}")
        else:
            ok = (max(rel.values()) <= STEP_F32_RTOL
                  and max(logit_err.values()) <= 1e-4
                  and logs["n_upd_D"] == cpu_logs["n_upd_D"]
                  and grad_rel[worst_g] <= g_band)
            band = (f"losses <= {STEP_F32_RTOL}, logit means and distance "
                    f"<= 1e-4 absolute, G's per-parameter gradient <= "
                    f"{g_band:.3g}; D's against float64 above")
        print(f"GAN step card {'bf16 mixed' if mixed else 'fp32'} vs CPU "
              f"fp32 (nf={NF}, nb={NB}, te={GAN_CMP_TE}, LR 16x16, STNet "
              f"{GAN_CMP_HR}^2): losses {logs} vs {cpu_logs}; "
              f"loss rel diffs { {k: round(v, 6) for k, v in rel.items()} }, "
              f"logit means/distance abs diffs "
              f"{ {k: float(f'{v:.3g}') for k, v in logit_err.items()} }; "
              f"G gradient max rel L2 {grad_rel[worst_g]:.3g} ({worst_g}), "
              f"D's {max(v for k, v in grad_rel.items() if k[0] == 'd'):.3g}"
              f"; cosine G {cos_g:.6f} D {cos_d:.6f} [{band}]: "
              f"{'ok' if ok else 'FAIL'}")
        _require(ok, f"card {'bf16' if mixed else 'fp32'} GAN step outside "
                 f"its band")


# ------------------------------------------------- fp32 passes against f64

# every fp32 convolution and linear pass (forward, input gradient, weight
# gradient) of one FRVSR and one GAN step on the card, recomputed on the
# CPU from the same operands in float64 and in fp32
# (tools/conv_audit.py): the card within F32_PASS_FACTOR x the CPU fp32's
# relative L2 distance from float64 on the same call, or within
# F32_PASS_FLOOR, twice the largest CPU fp32 distance of any audited pass
# (2.02e-6, D's conv_in weight gradient, on an NVIDIA H100 80GB HBM3's
# host); F32_PASS_CALLS calls of each (layer, pass) are checked
F32_PASS_FACTOR = 4.0
F32_PASS_FLOOR = 4e-6
F32_PASS_CALLS = 3


def _from_float64(layer, kind, pass_):
    """The passes an fp32 step computes from float64 operands and rounds
    once (``nn.F64ForwardConv2d``): D's convolution forwards."""
    return layer.startswith("d.") and kind == "conv2d" and pass_ == "forward"


def _audit_step(label, run, rows, prefix=""):
    """``run(recorder)`` (one fp32 step on the card) inside a
    ``conv_audit.PassRecorder`` and ``_route_count``; the passes of its
    layers named ``prefix``... audited (``_from_float64``'s held to one
    rounding) and added to ``rows``. Returns the route's [D forwards,
    calls from float64]."""
    import torch

    from tecogan_tpu_torch.tools import conv_audit

    rec = conv_audit.PassRecorder(F32_PASS_CALLS)
    with _route_count() as routed:
        run(rec)
    torch.cuda.synchronize()
    start = time.perf_counter()
    got = conv_audit.audit([c for c in rec.calls
                            if c.layer.startswith(prefix)],
                           F32_PASS_FACTOR, F32_PASS_FLOOR,
                           rounded_once=_from_float64)
    print(f"fp32 passes, {label}: {len(got)} (layer, pass) rows from "
          f"{len(rec.calls)} recorded calls; CPU float64/fp32 recompute "
          f"{time.perf_counter() - start:.1f} s; D's convolution forwards "
          f"from float64: {routed[1]} of {routed[0]}")
    rows += [dict(r, step=label) for r in got]
    return routed


def phase_f32_conv_audit(card, sd, gan_case, out=None):
    """One fp32 FRVSR step at phase 10's geometry (batch 2 x 10 frames of
    136^2 GT, remat) and one fp32 GAN step on ``gan_case`` (``_d_band_case``:
    te=3, STNet at 64^2, VGG19) on the card, inside a
    ``conv_audit.PassRecorder``; each recorded pass recomputed on the CPU
    in float64 and fp32, D's forwards also held to one rounding of
    float64. Prints one line per pass outside its band and the worst pass;
    ``out``: a path for the JSON of every row. Raises if any pass is
    outside its band or a D forward of the GAN step did not come from
    float64. Then the same GAN step with D's forwards under cuDNN (as
    before the route existed): raises unless block 1's forward, the pass
    that moved the D gradients of phase 13 on ``gan_case``'s inputs, is
    outside one rounding there. Returns the rows of the step as it runs."""
    import torch

    start = time.perf_counter()
    batch = _gt_clips(np.random.default_rng(SEED + 16), TRAIN_BATCH,
                      TRAIN_T, 128 + 2 * int(1.5 * 3))
    rows = []
    _audit_step("FRVSR", lambda rec: _one_step(sd, batch, "cuda", False,
                                               recorder=rec), rows)
    routed = _audit_step("GAN", lambda rec: _one_gan_step(
        *gan_case[:2], "cuda", False, recorder=rec), rows)
    for r in rows:
        if not r["ok"]:
            print(f"  OUTSIDE: {r['step']} {r['layer']} ({r['kind']}) "
                  f"{r['pass']}: card {r['device']:.3g}, CPU fp32 "
                  f"{r['cpu']:.3g}, band {r['band']:.3g}, roundings "
                  f"{r['rounding']} ({r['calls']} calls)")
    worst = max(rows, key=lambda r: r["device"] / r["band"])
    bad = [r for r in rows if not r["ok"]]
    kinds = sorted({r["kind"] for r in rows})
    once = {r["layer"]: r["rounding"] for r in rows
            if r["rounding"] is not None}
    print(f"fp32 passes against float64: {len(rows)} (layer, pass) rows "
          f"({', '.join(kinds)}), {len(bad)} outside [card <= max("
          f"{F32_PASS_FACTOR}x CPU fp32, {F32_PASS_FLOOR}); D's convolution "
          f"forwards within one rounding of float64]; worst "
          f"{worst['step']} {worst['layer']} {worst['pass']}: card "
          f"{worst['device']:.3g}, CPU fp32 {worst['cpu']:.3g}, band "
          f"{worst['band']:.3g}; D's forwards in roundings "
          f"{ {k: round(v, 3) for k, v in once.items()} }; "
          f"{time.perf_counter() - start:.1f} s on {card}")
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
    _require({"conv2d", "conv_transpose2d", "linear"} <= set(kinds)
             and all(sum(r["kind"] == k and r["pass"] == p for r in rows)
                     for k in kinds for p in ("forward", "dgrad", "wgrad")),
             f"the audit missed a kind of pass: {kinds}")
    _require(len(once) == 5, f"the audit held {len(once)} of D's 5 "
             f"convolution forwards to one rounding")
    _require(routed[0] == routed[1] > 0, f"the card's fp32 GAN step ran "
             f"{routed[1]} of D's {routed[0]} convolution forwards from "
             f"float64")
    _require(not bad, f"{len(bad)} fp32 passes on the card are further from "
             f"float64 than their band")

    # the check sees the forwards the route replaced: D's under cuDNN
    control = []
    with _cudnn_forwards():
        _audit_step("GAN, D's forwards under cuDNN", lambda rec: _one_gan_step(
            *gan_case[:2], "cuda", False, recorder=rec), control, "d.")
    cudnn = {r["layer"]: (round(r["rounding"], 3), float(f"{r['device']:.3g}"))
             for r in control if r["rounding"] is not None}
    block1 = "d.discriminator_block.block1.0"
    print(f"D's convolution forwards under cuDNN, (roundings of float64, "
          f"relative L2): {cudnn} [the route's: <= 1 rounding]")
    _require(cudnn.get(block1, (0.0,))[0] > 1.0, "one rounding of float64 "
             "does not tell block 1's cuDNN forward from the route's")

    # D's forwards feed LeakyReLU's kink: on the case's D inputs, how many
    # LeakyReLU inputs the card's fp32 step puts on the other side of it
    # from float64's, with cuDNN's fp32 forwards and from float64 (printed
    # only; phase 13 holds the gradients to their band)
    from tecogan_tpu_torch import nn as tnn

    sd_d, (x_real, x_fake) = gan_case[0]["d"], gan_case[2]
    ref = _kink_inputs(sd_d, x_real, x_fake, "cpu", torch.float64)
    for label, route in (("under cuDNN", _cudnn_forwards()),
                         ("from float64", contextlib.nullcontext())):
        with route:
            _kink_flips(f"card fp32 step, D's forwards {label}",
                        _kink_inputs(sd_d, x_real, x_fake, "cuda",
                                     numerics=tnn.training_numerics(False)),
                        ref)
    return rows


def _digest(*tensors):
    """sha256 of the tensors' bytes."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def bf16_digests():
    """sha256 of G's weights after phase 10's configuration trains 5 bf16
    steps and of G's and D's after phase 12's does (weights and batches
    drawn from ``SEED + 20``), printed as one JSON line: equal between two
    checkouts when their bf16 steps are bit for bit the same. Not a phase:
    run it in each checkout on the card,

        python3 -c "import chip_smoke as cs; cs.bf16_digests()"
    """
    from tecogan_tpu_torch.models import VSRGANModel, VSRModel
    from tecogan_tpu_torch.utils.ckpt import save_pytree

    def weights(*nets):
        return _digest(*(v for net in nets
                         for _, v in sorted(net.state_dict().items())))

    rng = np.random.default_rng(SEED + 20)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        model = VSRModel(_train_opt(tmp))
        for _ in range(TRAIN_STEPS):
            gt = _gt_clips(rng, TRAIN_BATCH, TRAIN_T, 136)
            model.train(model.prepare_training_data({"gt": gt}))
        out["frvsr_g"] = weights(model.net_g)
        g_path = os.path.join(tmp, "G.npz")
        save_pytree(_jax_layout_params(rng, NF, NB, SCALE), g_path)
        opt = _gan_opt(tmp, g_path)
        model = VSRGANModel(opt)
        n = opt["dataset"]["train"]["batch_size_per_gpu"]
        for _ in range(GAN_STEPS):
            gt = _gt_clips(rng, n, opt["train"]["tempo_extent"], 136)
            model.train(model.prepare_training_data({"gt": gt}))
        out["tecogan_g"] = weights(model.net_g)
        out["tecogan_d"] = weights(model.net_d)
    print(f"bf16 digests: {json.dumps(out)}", flush=True)


# ------------------------------------------------------ train mode (CLI)

SHIPPED_FRVSR_REDS_YML = "experiments_BD/FRVSR/FRVSR_REDS_4xSR_2GPU/train.yml"
SHIPPED_GAN_REDS_YML = "experiments_BD/TecoGAN/TecoGAN_REDS_4xSR_2GPU/train.yml"
SHIPPED_BI_TRAIN_YML = ("experiments_BI/FRVSR/FRVSR_VimeoTecoGAN_4xSR_2GPU/"
                        "train.yml")
# REDS's published frame geometry, cut from 240 sequences x 100 frames to
# the first 4 names of data/meta/REDS/train_list.txt x 30 frames, and one
# 10-frame validation sequence named as the first of the shipped
# filter_list
REDS_GT, REDS_FRAMES, REDS_VIDS = (720, 1280), 30, ("001", "002", "003",
                                                     "004")
REDS_VAL_VID, REDS_VAL_FRAMES = "000", 10
BI_VIDS, BI_FRAMES = ("001", "002"), 12
# the loop's cadence: 12 iterations, checkpoints at 5, 10 and 12,
# validation at 6 and 12; then a resume to 15 and a run with nothing left
LOOP_ITERS, LOOP_CKPT, LOOP_TEST, LOOP_RESUME = 12, 5, 6, 15
# the loop's time in turns (TURNS: True for the device-resident loader),
# two pairs of TURN_ITERS iterations each without checkpoints or
# validation
TURNS = (False, True, True, False)
TURN_ITERS, PROFILE_ITERS, GAN_LOOP_ITERS = 20, 3, 4
LOADER_BATCHES = 40
RESIDENT_CHECK_BATCHES = 4
CLI_GPU = "0"


class _TrainProbe:
    """Wraps ``VSRModel.train`` (VSRGANModel's too),
    ``prepare_training_data`` and ``get_format_msg`` for one CLI run: the
    host clock at each train call's entry, each call's (start, end), the
    model, the host batches the loop copied (``keep``) and a torch.profiler
    window over the loop iterations [profile_from, profile_from +
    PROFILE_ITERS) of the run (1-based)."""

    _WRAPPED = ("train", "prepare_training_data", "get_format_msg")

    def __init__(self, keep=False, profile_from=None):
        self.keep, self.profile_from = keep, profile_from
        self.entries, self.model, self.host_batches = [], None, []
        self.spans = {name: [] for name in self._WRAPPED}
        self.prof, self.window = None, None

    def _enter(self, model, batch):
        import torch

        self.model = model
        k = len(self.entries) + 1
        if self.profile_from is not None and k in (
                self.profile_from, self.profile_from + PROFILE_ITERS):
            torch.cuda.synchronize()
            if k == self.profile_from:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.start()
                self.window = time.perf_counter()
            else:
                self.prof.stop()
                self.window = time.perf_counter() - self.window
        self.entries.append(time.perf_counter())

    def _timed(self, name, orig):
        def call(model, *args):
            if name == "train":
                self._enter(model, args[0])
            elif name == "prepare_training_data" and self.keep:
                self.host_batches.append(args[0])
            t0 = time.perf_counter()
            out = orig(model, *args)
            self.spans[name].append((t0, time.perf_counter()))
            return out

        return call

    def __enter__(self):
        from tecogan_tpu_torch.models import base, vsr_model

        self._saved = [(cls, name, getattr(cls, name)) for cls, name in (
            (vsr_model.VSRModel, "train"),
            (base.BaseVSRModel, "prepare_training_data"),
            (base.BaseVSRModel, "get_format_msg"))]
        for cls, name, orig in self._saved:
            setattr(cls, name, self._timed(name, orig))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)

    def idle_share(self):
        """(wall ms, kernel ms, device idle share) of the profiled window;
        kernel ms and the share are None when no device time was
        recorded."""
        from torch.autograd import DeviceType

        busy = sum(e.self_device_time_total
                   for e in self.prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        wall = self.window * 1e3
        return wall, busy or None, (1 - busy / wall) if busy else None


def _train_log_lines(lines):
    """The JAX format's per-iteration lines: [(epoch, iter, lr_G, lr_D or
    None, {loss: value})]."""
    import re

    line = re.compile(r"^\[epoch: (\d+) \| iter: (\d+) \| lr_G: (\S+?)"
                      r"(?: \| lr_D: (\S+?))?\] (.*)$")
    out = []
    for m in filter(None, map(line.match, lines)):
        ep, it, lr_g, lr_d, rest = m.groups()
        logs = {kv.split(": ")[0]: float(kv.split(": ")[1])
                for kv in rest.split(", ")}
        out.append((int(ep), int(it), float(lr_g),
                    None if lr_d is None else float(lr_d), logs))
    return out


def _cli_train(exp, opt, probe=None):
    """``tecogan_tpu_torch.main.main --mode train --gpu_ids 0`` in process
    on ``opt`` written to ``exp/train.yml``. Returns (model, log lines,
    launch counts, host seconds)."""
    import torch

    from tecogan_tpu_torch.main import main as cli_main
    from tecogan_tpu_torch.utils.yaml_subset import safe_dump

    os.makedirs(exp, exist_ok=True)
    yml = os.path.join(exp, "train.yml")
    with open(yml, "w") as f:
        f.write(safe_dump(opt))
    probe = probe or _TrainProbe()
    reset_kernel_launches()
    with _LogLines() as lines, probe:
        t0 = time.perf_counter()
        model = cli_main(["--exp_dir", exp, "--mode", "train", "--opt", yml,
                          "--gpu_ids", CLI_GPU])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return model, list(lines), kernel_launches(), secs


def _loop_ms(probe, start_iter, skip):
    """Host-clock ms of each loop iteration (from one train call's entry to
    the next's: the step, its log read, checkpoint or validation, the next
    batch and its copy), leaving out the first iteration of the run and
    the iterations in ``skip``."""
    t = probe.entries
    return {start_iter + k + 1: (t[k + 1] - t[k]) * 1e3
            for k in range(1, len(t) - 1)
            if start_iter + k + 1 not in skip}


def _loop_parts(probe, iters):
    """Median host ms of each part of the loop iterations ``iters`` (a log
    line every iteration): the train call (the step's launches: it returns
    before the card is done), the log line (its read of the running log
    waits for the card), waiting for the next batch, and its copy to the
    device (prepare_training_data)."""
    tr, prep, log = (probe.spans[k] for k in _TrainProbe._WRAPPED)
    parts = {"train call": [], "log read": [], "batch wait": [], "copy": [],
             "rest": []}
    for i in iters:
        j = i - 1
        total = tr[j + 1][0] - tr[j][0]
        got = {"train call": tr[j][1] - tr[j][0],
               "log read": log[j][1] - log[j][0],
               "batch wait": prep[j + 1][0] - log[j][1],
               "copy": prep[j + 1][1] - prep[j + 1][0]}
        got["rest"] = total - sum(got.values())
        for k, v in got.items():
            parts[k].append(v * 1e3)
    return ", ".join(f"{k} {float(np.median(v)):.2f}"
                     for k, v in parts.items())


def _alone(probe):
    """The run's host batches copied to the card again, each copy timed
    alone (``prepare_training_data``, synchronised), then ``model.train``
    alone on them, one synchronised step each after a warm-up step.
    Returns (copy ms, train ms) of the steps after the first."""
    import torch

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    model = probe.model
    copies = [timed(lambda b=b: model.prepare_training_data(b))
              for b in probe.host_batches]
    steps = [timed(lambda b=b: model.train(b))[1] for b, _ in copies]
    return [ms for _, ms in copies[1:]], steps[1:]


def _median_min(ms):
    v = sorted(ms.values() if isinstance(ms, dict) else ms)
    return f"median {float(np.median(v)):.2f}, min {v[0]:.2f}"


def _require_counts(label, counts, per_iter, iters, k1=0):
    """The run's launches equal ``iters`` times one iteration's structure
    (per_iter: K2, K3+K4, K4 and K3 alone), plus ``k1`` K1 launches."""
    expected = {**dict.fromkeys(counts, 0), "K1": k1,
                "K2": iters * per_iter["K2"],
                "K3": iters * (per_iter["K3+K4"] + per_iter["K3 alone"]),
                "K3+K4": iters * per_iter["K3+K4"],
                "K4": iters * per_iter["K4"]}
    print(f"train mode {label}: launches {counts}, expected {expected}")
    _require(counts == expected, f"train mode {label}: the launch counts "
             f"differ from the structure")


def _write_reds(tmp, rng):
    """The records store (REDS's geometry) and the validation PNGs."""
    from tecogan_tpu_torch.data.records import RecordWriter
    from tecogan_tpu_torch.ops.color import float32_to_uint8

    store = f"{tmp}/REDS/GT.lmdb"
    w = RecordWriter(store)
    for vid in REDS_VIDS:
        w.add_sequence(vid, float32_to_uint8(
            _smooth_frames(rng, REDS_FRAMES, *REDS_GT)))
    w.close()
    val = f"{tmp}/REDS/Raw"
    _write_seq(f"{val}/{REDS_VAL_VID}", float32_to_uint8(
        _smooth_frames(rng, REDS_VAL_FRAMES, *REDS_GT)))
    return store, val


def _write_bi(tmp, rng):
    """A paired store: GT at REDS's geometry and its imresize_matlab 4x LR
    (computed on the card)."""
    import torch

    from tecogan_tpu_torch.data.records import RecordWriter
    from tecogan_tpu_torch.ops.color import float32_to_uint8
    from tecogan_tpu_torch.ops.degrade import imresize_matlab

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    gt_w, lr_w = (RecordWriter(f"{tmp}/BI/GT.lmdb"),
                  RecordWriter(f"{tmp}/BI/LR.lmdb"))
    for vid in BI_VIDS:
        gt = float32_to_uint8(_smooth_frames(rng, BI_FRAMES, *REDS_GT))
        lr = imresize_matlab(torch.from_numpy(gt).to(dev, torch.float32)
                             / 255.0, scale=1 / SCALE)
        gt_w.add_sequence(vid, gt)
        lr_w.add_sequence(vid, float32_to_uint8(lr.cpu().numpy()))
    gt_w.close()
    lr_w.close()
    return f"{tmp}/BI/GT.lmdb", f"{tmp}/BI/LR.lmdb"


def _frvsr_reds_opt(store, val, **cadence):
    """The shipped FRVSR REDS train.yml with its data paths and the cadence
    replaced."""
    opt = _shipped(SHIPPED_FRVSR_REDS_YML)
    opt["dataset"]["train"]["seq_dir"] = store
    opt["dataset"]["test"]["gt_seq_dir"] = val
    # the shipped width unless a rehearsal cuts it
    opt["model"]["generator"].update(nf=NF, nb=NB)
    for key, section in (("total_iter", "train"), ("log_freq", "logger"),
                         ("ckpt_freq", "logger"), ("test_freq", "test")):
        if key in cadence:
            opt[section][key] = cadence[key]
    return opt


def _check_resident(label, opt, card):
    """The device-resident loader's batches on the card, bit for bit the
    host loader's: the first batches of epoch 0, and of epoch 1 entered at
    batch 2."""
    import itertools

    import torch

    from tecogan_tpu_torch.data import create_dataloader

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    host = create_dataloader(opt, "train", "train")
    opt = {**opt, "dataset": {**opt["dataset"], "train": {
        **opt["dataset"]["train"], "device_resident": True}}}
    t0 = time.perf_counter()
    resident = create_dataloader(opt, "train", "train", device=dev)
    upload = time.perf_counter() - t0
    n = 0
    for epoch, start in ((0, 0), (1, 2)):
        gen = host.epoch(epoch, start_batch=start)
        want = list(itertools.islice(gen, RESIDENT_CHECK_BATCHES))
        gen.close()
        got = list(itertools.islice(resident.epoch(epoch, start_batch=start),
                                    RESIDENT_CHECK_BATCHES))
        _require(len(got) == len(want) == RESIDENT_CHECK_BATCHES,
                 f"{label}: {len(got)} and {len(want)} batches")
        for a, b in zip(got, want):
            _require(set(a) == set(b), f"{label}: keys {set(a)} {set(b)}")
            for k in a:
                _require(a[k].device.type == dev.type
                         and a[k].dtype == torch.uint8
                         and np.array_equal(a[k].cpu().numpy(), b[k]),
                         f"{label}: device-resident {k} differs from the "
                         f"host loader's")
                n += 1
    corpus = sum(c.numel() for c in resident._clips.values())
    print(f"device-resident loader {label}: {n} tensors of "
          f"{2 * RESIDENT_CHECK_BATCHES} batches (epoch 0, and epoch 1 from "
          f"batch 2) bit-identical to the host loader's on {dev}; corpus "
          f"{corpus / 2 ** 20:.1f} MiB uploaded in {upload:.2f} s (host "
          f"clock, reading the store included) on {card}")


def _loader_rate(opt, assembler, card):
    """Batches/s of the host loader alone (no training) over
    LOADER_BATCHES batches after one, with the native or the numpy
    assembler."""
    import itertools

    from tecogan_tpu_torch.data import create_dataloader

    loader = create_dataloader(opt, "train", "train")
    store = loader.dataset.store
    if assembler == "numpy":
        store._native_tried, store._native = True, None
    _require(store.assembler == assembler, f"the {assembler} assembler is "
             f"not in use: {store.assembler}")
    gen = loader.epoch(0)
    next(gen)
    t0 = time.perf_counter()
    n = sum(1 for _ in itertools.islice(gen, LOADER_BATCHES))
    secs = time.perf_counter() - t0
    gen.close()
    _require(n == LOADER_BATCHES, f"the loader gave {n} batches")
    rate = n / secs
    print(f"host loader alone, {assembler} assembler "
          f"({loader.num_workers} workers, batch {loader.batch_size} x "
          f"{loader.dataset.tempo_extent} frames of "
          f"{loader.dataset.crop_size}^2 uint8 from {REDS_GT[0]}x"
          f"{REDS_GT[1]}): {rate:.2f} batches/s over {n} batches (host "
          f"clock) on {card}")
    return rate


def phase_train_mode(card):
    """Train mode through the port's CLI (``tecogan_tpu_torch.main.main``,
    in process, card 0) on the shipped REDS and BI train.ymls at full
    width, from a records store at REDS's frame geometry: FRVSR's cadence
    (logs, checkpoints, validation, resume, nothing left), the loop's
    time against model.train alone, the device idle share, the host
    loader's rate with either assembler, the device-resident loader (bit
    for bit the host loader's, and its loop time), BI, and TecoGAN.
    Returns the launches of the runs."""
    import torch

    from tecogan_tpu_torch.utils.ckpt import save_pytree

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 14)
    launches = dict.fromkeys(("K1", "K2", "K3", "K3+K4", "K4"), 0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store, val = _write_reds(tmp, rng)
        size = os.path.getsize(f"{store}/data.bin")
        print(f"train mode: records store of {len(REDS_VIDS)} x "
              f"{REDS_FRAMES} frames of {REDS_GT[0]}x{REDS_GT[1]} "
              f"({size / 1e6:.1f} MB) and {REDS_VAL_FRAMES} validation "
              f"PNGs written in {time.perf_counter() - t0:.2f} s")

        # FRVSR, 12 iterations
        opt = _frvsr_reds_opt(store, val, total_iter=LOOP_ITERS, log_freq=1,
                              ckpt_freq=LOOP_CKPT, test_freq=LOOP_TEST)
        exp = f"{tmp}/exp_frvsr"
        probe = _TrainProbe(keep=True)
        model, lines, counts, secs = _cli_train(exp, opt, probe)
        add(counts)
        te = opt["train"]["tempo_extent"]
        per_iter = _expected_launches(te, model.cfg_g.remat)
        per_iter["K3 alone"] = per_iter["K3"] - per_iter["K3+K4"]
        n_pad = opt["test"]["num_pad_front"]
        validations = LOOP_ITERS // LOOP_TEST
        k1 = validations * _frames_warped(REDS_VAL_FRAMES + n_pad, 16)
        _require_counts("FRVSR", counts, per_iter, LOOP_ITERS, k1)
        logs = _train_log_lines(lines)
        _require([it for _, it, *_ in logs] == list(range(1, LOOP_ITERS + 1))
                 and all(lr_d is None and lr_g > 0 and list(v) == [
                     "l_pix_G", "l_warp_G"] and all(map(math.isfinite,
                                                        v.values()))
                         for _, _, lr_g, lr_d, v in logs),
                 f"FRVSR: the log lines are not the JAX format's, one an "
                 f"iteration: {logs}")
        print(f"FRVSR log, iteration {LOOP_ITERS}: "
              f"{[m for m in lines if m.startswith('[epoch')][-1]}")
        ckpts = sorted(os.listdir(f"{exp}/train/ckpt"))
        want = sorted([f"G_iter{i}.npz" for i in (5, 10, 12)]
                      + [f"state_iter{i}.pth" for i in (5, 10, 12)])
        _require(ckpts == want, f"FRVSR checkpoints {ckpts}, want {want}")
        with open(f"{exp}/test/metrics/REDS_avg.json") as f:
            metrics = json.load(f)
        _require(list(metrics) == ["G_iter6", "G_iter12"]
                 and all(math.isfinite(float(m["PSNR"]))
                         for m in metrics.values()),
                 f"FRVSR validation entries {metrics}")
        native = [m for m in lines if "clips assembled by" in m]
        _require(len(native) == 1 and "native assembler" in native[0],
                 f"the native assembler is not in use: {native}")
        print(f"FRVSR train mode: {LOOP_ITERS} iterations in {secs:.2f} s "
              f"(host clock, model build and validations included); "
              f"checkpoints {ckpts}; validation {metrics}; {native[0]}")

        skip = {i for i in range(1, LOOP_ITERS + 1)
                if i % LOOP_CKPT == 0 or i % LOOP_TEST == 0}
        loop = _loop_ms(probe, 0, skip)
        copy, alone = _alone(probe)
        print(f"loop ms/iteration through the CLI (host clock, host loader, "
              f"iterations {sorted(loop)}: not the first, nor those with a "
              f"checkpoint or a validation): {_median_min(loop)}; "
              f"model.train alone on the same {len(probe.host_batches)} batches "
              f"(prepared before the clock, synchronised, after one warm-up "
              f"step): {_median_min(alone)}; their copies alone "
              f"{_median_min(copy)} on {card}")
        print(f"loop parts, host loader (median ms over the same "
              f"iterations): {_loop_parts(probe, sorted(loop))}")
        del model, probe

        # resume to 15, then a run with nothing left
        for total, first in ((LOOP_RESUME, LOOP_ITERS + 1),
                             (LOOP_RESUME, None)):
            state_file = f"{exp}/train/ckpt/state_iter{LOOP_RESUME}.pth"
            before = (os.path.getmtime(state_file)
                      if os.path.exists(state_file) else None)
            opt["train"]["total_iter"] = total
            model, lines, counts, _ = _cli_train(exp, opt)
            add(counts)
            its = [it for _, it, *_ in _train_log_lines(lines)]
            if first is not None:
                _require(its == list(range(first, total + 1))
                         and model.state["step"] == total
                         and os.path.exists(
                             f"{exp}/train/ckpt/G_iter{total}.npz"),
                         f"the resumed run logged iterations {its}, step "
                         f"{model.state['step']}")
                _require_counts("FRVSR resumed", counts, per_iter,
                                total - first + 1)
                print(f"resume: iterations {its} trained from "
                      f"state_iter{LOOP_ITERS}.pth; G_iter{total}.npz "
                      f"written")
            else:
                _require(its == [] and model.state["step"] == total
                         and os.path.getmtime(state_file) == before,
                         f"a run with the budget spent trained {its}")
                _require_counts("FRVSR, budget spent", counts, per_iter, 0)
                print("a third run with total_iter spent trained no "
                      "iteration and rewrote nothing")
            del model

        # the device idle share over 3 loop iterations (a fresh run,
        # no checkpoint or validation)
        probe = _TrainProbe(profile_from=2)
        opt_p = _frvsr_reds_opt(store, val, total_iter=PROFILE_ITERS + 2,
                                log_freq=1, ckpt_freq=0, test_freq=0)
        model, _, counts, _ = _cli_train(f"{tmp}/exp_profile", opt_p, probe)
        add(counts)
        wall, busy, idle = probe.idle_share()
        print(f"device idle share over {PROFILE_ITERS} loop iterations "
              f"(2-{PROFILE_ITERS + 1}, host loader, under torch.profiler): "
              f"wall {wall:.2f} ms, kernels {_ms(busy)} ms, idle "
              + ("not measured" if idle is None else f"{idle:.3f}")
              + f" on {card}")
        if busy is not None:
            # the profiler slows the host; against the unprofiled loop
            median = float(np.median(list(loop.values())))
            print(f"kernels per loop iteration {busy / PROFILE_ITERS:.2f} ms "
                  f"against the unprofiled loop's median {median:.2f} ms: "
                  f"device idle about "
                  f"{1 - busy / PROFILE_ITERS / median:.3f} on {card}")
        del model, probe

        # the host loader alone, native then numpy assembler
        rates = {a: _loader_rate(opt, a, card) for a in ("native", "numpy")}

        # device-resident: batches bit for bit, then the loop's time in
        # turns with the host loader's (and model.train alone)
        _check_resident("BD", opt, card)
        medians = {False: [], True: []}
        for k, resident in enumerate(TURNS):
            label = "device-resident" if resident else "host loader"
            probe = _TrainProbe(keep=not resident)
            opt_t = _frvsr_reds_opt(store, val, total_iter=TURN_ITERS,
                                    log_freq=1, ckpt_freq=0, test_freq=0)
            opt_t["dataset"]["train"]["device_resident"] = resident
            model, lines, counts, _ = _cli_train(f"{tmp}/exp_turn{k}", opt_t,
                                                 probe)
            add(counts)
            _require_counts(f"FRVSR turn {k}, {label}", counts, per_iter,
                            TURN_ITERS)
            _require(len(_train_log_lines(lines)) == TURN_ITERS,
                     f"turn {k}: not one log line an iteration")
            ms = _loop_ms(probe, 0, set())
            medians[resident].append(float(np.median(list(ms.values()))))
            print(f"turn {k}, {label}: loop ms/iteration (iterations "
                  f"{sorted(ms)}) {_median_min(ms)}; parts (median ms) "
                  f"{_loop_parts(probe, sorted(ms))} on {card}")
            if not resident:
                copy, alone = _alone(probe)
                print(f"turn {k}, the same batches alone: model.train "
                      f"{_median_min(alone)}, copies {_median_min(copy)}")
            del model, probe
        host, res = medians[False], medians[True]
        pairs = [medians[True][i] / medians[False][i] for i in range(len(host))]
        print(f"device-resident against host loader over {len(TURNS)} turns "
              f"of {TURN_ITERS} iterations (medians, ms): host {host}, "
              f"resident {res}; resident/host in each pair "
              f"{[round(r, 4) for r in pairs]}, on the means "
              f"{np.mean(res) / np.mean(host):.4f}; "
              + ("resolved: every resident turn "
                 + ("faster" if max(res) < min(host) else "slower")
                 + " than every host turn"
                 if max(res) < min(host) or min(res) > max(host)
                 else "unresolved: the turns overlap") + f" on {card}")

        # BI: the paired store, its batches on the card, 3 iterations
        gt_dir, lr_dir = _write_bi(tmp, rng)
        opt_bi = _shipped(SHIPPED_BI_TRAIN_YML)
        opt_bi["dataset"]["train"].update(gt_seq_dir=gt_dir,
                                          lr_seq_dir=lr_dir)
        opt_bi["model"]["generator"].update(nf=NF, nb=NB)
        opt_bi["train"]["total_iter"] = 3
        opt_bi["logger"].update(log_freq=1, ckpt_freq=0)
        opt_bi["test"]["test_freq"] = 0
        _check_resident("BI", opt_bi, card)
        model, lines, counts, _ = _cli_train(f"{tmp}/exp_bi", opt_bi)
        add(counts)
        logs = _train_log_lines(lines)
        _require(len(logs) == 3 and all(
            math.isfinite(v) for *_, d in logs for v in d.values()),
            f"BI: {logs}")
        print(f"BI train mode (the shipped BI FRVSR train.yml, GT "
              f"{REDS_GT[0]}x{REDS_GT[1]}): 3 iterations, last log "
              f"{[m for m in lines if m.startswith('[epoch')][-1]}")
        del model

        # TecoGAN, 4 iterations
        g_path = f"{tmp}/G_seed.npz"
        save_pytree(_jax_layout_params(rng, NF, NB, SCALE), g_path)
        opt_g = _shipped(SHIPPED_GAN_REDS_YML)
        opt_g["dataset"]["train"]["seq_dir"] = store
        opt_g["dataset"]["test"]["gt_seq_dir"] = val
        opt_g["model"]["generator"].update(nf=NF, nb=NB, load_path=g_path)
        opt_g["train"]["feature_crit"]["allow_random_weights"] = True
        opt_g["train"]["total_iter"] = GAN_LOOP_ITERS
        opt_g["logger"].update(log_freq=1, ckpt_freq=GAN_LOOP_ITERS)
        opt_g["test"]["test_freq"] = 0
        exp = f"{tmp}/exp_gan"
        model, lines, counts, secs = _cli_train(exp, opt_g)
        add(counts)
        gan_iter = _gan_expected_launches(
            2 * opt_g["train"]["tempo_extent"] - 1, model.cfg_g.remat)
        gan_iter["K3 alone"] = gan_iter["K3"] - gan_iter["K3+K4"]
        _require_counts("TecoGAN", counts, gan_iter, GAN_LOOP_ITERS)
        logs = _train_log_lines(lines)
        _require(len(logs) == GAN_LOOP_ITERS and all(
            lr_d is not None and math.isfinite(v)
            for _, _, _, lr_d, d in logs for v in d.values()),
            f"TecoGAN log lines {logs}")
        ckpts = sorted(os.listdir(f"{exp}/train/ckpt"))
        want = [f"D_iter{GAN_LOOP_ITERS}.npz", f"G_iter{GAN_LOOP_ITERS}.npz",
                f"state_iter{GAN_LOOP_ITERS}.pth"]
        _require(ckpts == want, f"TecoGAN checkpoints {ckpts}")
        print(f"TecoGAN train mode (the shipped TecoGAN REDS train.yml): "
              f"{GAN_LOOP_ITERS} iterations in {secs:.2f} s (host clock, "
              f"model build included), checkpoints {ckpts}, last log "
              f"{[m for m in lines if m.startswith('[epoch')][-1]}")
        del model
        torch.cuda.empty_cache()
    print(f"train mode phase: {time.perf_counter() - t_phase:.1f} s wall "
          f"(host clock), loader rates {rates}")
    return launches


# ------------------------------------------------------------- serving

# bench.py's geometry: one stream of 64 LR frames of 134x320, chunk 16
SERVE_T, SERVE_LR, SERVE_CHUNK = 64, (134, 320), 16
# serve.main's artifact and sequences: 40 frames with 5 of pre-roll fit
# its 48, a 50-frame sequence does not
SERVE_ART_T, SERVE_SEQ_T, SERVE_PAD, SERVE_LONG_T = 48, 40, 5, 50
SHIPPED_FRVSR_VIMEO_YML = ("experiments_BD/FRVSR/FRVSR_VimeoTecoGAN_4xSR_2GPU/"
                           "train.yml")


def _export(ckpt, out, t, dtype, *extra):
    """tools/export_serving.py in process; returns (seconds, blob bytes,
    file bytes)."""
    from tecogan_tpu_torch.tools import export_serving

    h, w = SERVE_LR
    t0 = time.perf_counter()
    blob, _ = export_serving.main([
        "--ckpt", ckpt, "--out", out, "--height", str(h), "--width", str(w),
        "--frames", str(t), "--chunk", str(SERVE_CHUNK), "--nf", str(NF),
        "--nb", str(NB), "--scale", str(SCALE), "--compute_dtype", dtype,
        *extra])
    return time.perf_counter() - t0, len(blob), os.path.getsize(out)


def _live(sd, cfg, x):
    """infer_sequence_batch on the card, the live path a program must
    equal, under the numerics a loaded program runs with."""
    from tecogan_tpu_torch.models.networks import FRNet, infer_sequence_batch
    from tecogan_tpu_torch.nn import inference_numerics

    net = FRNet.from_state_dict(cfg, sd, device="cuda")
    with inference_numerics(cfg.compute_dtype):
        return infer_sequence_batch(net, x, cfg, chunk=SERVE_CHUNK)


def _in_turns(fns, label, card):
    """bench.py's protocol for each of ``fns`` (label -> a call returning a
    uint8 tensor): one warm-up each, then five rounds in turns (the order
    reversed every other round), a checksum read back to force the sync;
    frames/s from the min of 5."""
    import torch

    for fn in fns.values():
        int(fn().sum(dtype=torch.int64).item())
    times = {k: [] for k in fns}
    order = list(fns)
    for rep in range(5):
        for k in (order if rep % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            int(fns[k]().sum(dtype=torch.int64).item())
            times[k].append(time.perf_counter() - t0)
    fps = {}
    for k, ts in times.items():
        fps[k] = SERVE_T / min(ts)
        print(f"FPS ({k}) {label}: {fps[k]:.2f} frames/s (min of 5: "
              f"{min(ts) * 1e3:.1f} ms; all {[round(t * 1e3, 1) for t in ts]})"
              f" on {card}")
    return fps


def _host_us(fn, n=300):
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    card then drains the queue)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _k1_operator_cost(card):
    """K1 at the serving path's (1,3,536,1280) bf16, the flow the NHWC view
    of an NCHW bf16 flow: host µs a call through the operator
    (``warp_planes``) against a direct call of its CUDA implementation,
    in turns; and the two outputs bit for bit."""
    import torch

    from tecogan_tpu_torch.ops import warp_cuda

    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    planes = torch.rand((1, 3, 536, 1280), generator=gen, device="cuda",
                        dtype=torch.float32).bfloat16()
    flow = _smooth_flow(gen, "cuda", 1, 536, 1280, 4.0).bfloat16().permute(
        0, 2, 3, 1)
    op = lambda: warp_cuda.warp_planes(planes, flow)  # noqa: E731
    direct = lambda: warp_cuda._warp_planes_cuda(planes, flow)  # noqa: E731
    _require(torch.equal(op(), direct()), "K1 through the operator differs "
             "from its direct launch")
    host = {"operator": [], "direct": []}
    for _ in range(3):
        for k, fn in (("operator", op), ("direct", direct),
                      ("direct", direct), ("operator", op)):
            host[k].append(_host_us(fn))
    events = {"operator": _cuda_ms(op, 200) * 1e3,
              "direct": _cuda_ms(direct, 200) * 1e3}
    print(f"K1 (1,3,536,1280) bf16, host us a call to enqueue (min of 6, in "
          f"turns): operator {min(host['operator']):.2f} (all "
          f"{[round(x, 2) for x in host['operator']]}), direct "
          f"{min(host['direct']):.2f} (all "
          f"{[round(x, 2) for x in host['direct']]}); CUDA events us a call "
          f"over 200: operator {events['operator']:.2f}, direct "
          f"{events['direct']:.2f} on {card}")
    return {k: min(v) for k, v in host.items()}


def phase_serving(card, params):
    """Phase 15: three artifacts of the flagship generator (bf16, fp32, bf16
    packed16; 1 x 64 frames of 134x320, chunk 16) exported by
    tools/export_serving.py and loaded by serving.load_artifact: each
    bit-identical to the live path, K1 (K5) once per warped frame and no
    other kernel; serve.main on PNG sequences (plain, with pre-roll, with a
    --ckpt override; a too-long sequence refused), every PNG equal to the
    live frames; the loaded bf16 program's FPS against the live path in
    turns, a profile of each, and K1's operator cost. Returns the K1 and K5
    launches of the loaded programs and of serve."""
    import torch

    from tecogan_tpu_torch import serve, serving
    from tecogan_tpu_torch.models.networks import FRNetConfig
    from tecogan_tpu_torch.ops.color import float32_to_uint8
    from tecogan_tpu_torch.utils.ckpt import save_pytree
    from tecogan_tpu_torch.utils.layout import state_dict_from_jax
    from tecogan_tpu_torch.utils.png import read_png

    rng = np.random.default_rng(SEED + 15)
    h, w = SERVE_LR
    sd = state_dict_from_jax(params)
    x = torch.from_numpy(_smooth_frames(rng, SERVE_T, h, w))[None].cuda()
    launches = {"K1": 0, "K5": 0}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/G.npz"
        save_pytree(params, ckpt)
        loaded = {}
        for label, dtype, extra in (("bf16", "bfloat16", ()),
                                    ("fp32", "float32", ()),
                                    ("bf16 packed16", "bfloat16",
                                     ("--packed16",))):
            path = f"{tmp}/{label.replace(' ', '_')}.tecosrv"
            export_s, blob_b, file_b = _export(ckpt, path, SERVE_T, dtype,
                                               *extra)
            t0 = time.perf_counter()
            run, meta, back = serving.load_artifact(path)
            load_s = time.perf_counter() - t0
            _require(set(back) == set(sd) and all(
                torch.equal(back[k], sd[k]) for k in sd),
                f"{label}: the embedded weights differ from the checkpoint's")
            cfg = FRNetConfig(nf=NF, nb=NB, scale=SCALE, compute_dtype=dtype,
                              packed16=bool(extra))
            reset_kernel_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run(back, x)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = kernel_launches()
            kernel = "K5" if extra else "K1"
            _require(counts == {**dict.fromkeys(counts, 0), kernel: SERVE_T},
                     f"{label} artifact: launches {counts}, expected "
                     f"{kernel} once per warped frame ({SERVE_T}) and no "
                     f"other kernel")
            launches[kernel] += counts[kernel]
            want = _live(sd, cfg, x)
            _require(got.shape == (1, SERVE_T, 4 * h, 4 * w, 3)
                     and torch.equal(got, want),
                     f"{label} artifact differs from infer_sequence_batch")
            print(f"serving artifact {label} (1x{SERVE_T}x{h}x{w}, chunk "
                  f"{SERVE_CHUNK}): export {export_s:.2f} s, program "
                  f"{blob_b} bytes, file {file_b} bytes (weights embedded), "
                  f"load {load_s:.2f} s, first call {first_s:.2f} s (host "
                  f"clock); bit-identical to the live path; launches "
                  f"{counts} on {card}")
            loaded[label] = (run, back, cfg)

        # serve.main on PNG sequences
        art = f"{tmp}/serve.tecosrv"
        _export(ckpt, art, SERVE_ART_T, "bfloat16")
        other = f"{tmp}/G_other.npz"
        params_b = _jax_layout_params(rng, NF, NB, SCALE)
        save_pytree(params_b, other)
        seqs = {}
        for name in ("s0", "s1"):
            seqs[name] = float32_to_uint8(_smooth_frames(rng, SERVE_SEQ_T,
                                                         h, w))
            _write_seq(f"{tmp}/in/{name}", seqs[name])
        cfg = loaded["bf16"][2]
        for run_i, (label, weights, args) in enumerate((
                ("plain", sd, []),
                (f"--pad_front {SERVE_PAD}", sd, ["--pad_front",
                                                  str(SERVE_PAD)]),
                ("--ckpt override", state_dict_from_jax(params_b),
                 ["--ckpt", other]))):
            out = f"{tmp}/out{run_i}"
            reset_kernel_launches()
            t0 = time.perf_counter()
            written = serve.main([art, f"{tmp}/in", out, "--quiet", *args])
            secs = time.perf_counter() - t0
            counts = kernel_launches()
            _require(written == {k: SERVE_SEQ_T for k in seqs}
                     and counts == {**dict.fromkeys(counts, 0),
                                    "K1": SERVE_ART_T * len(seqs)},
                     f"serve ({label}): wrote {written}, launches {counts}")
            launches["K1"] += counts["K1"]
            pad = SERVE_PAD if "pad_front" in label else 0
            for name, frames in seqs.items():
                lr = frames.astype(np.float32) / 255.0
                lr = np.concatenate([lr[1:1 + pad][::-1], lr])
                lr = np.concatenate(
                    [lr, np.repeat(lr[-1:], SERVE_ART_T - len(lr), 0)])
                want = _live(weights, cfg, torch.from_numpy(lr)[None].cuda())
                want = want[0, pad:pad + SERVE_SEQ_T].cpu().numpy()
                got = np.stack([read_png(f"{out}/{name}/{i:04d}.png")
                                for i in range(SERVE_SEQ_T)])
                _require(np.array_equal(got, want),
                         f"serve ({label}) {name}: PNGs differ from the live "
                         f"frames")
            print(f"serve ({label}): {len(seqs)} x {SERVE_SEQ_T} PNG frames "
                  f"of {h}x{w} in {secs:.2f} s (host clock, PNG I/O "
                  f"included), every PNG equal to the live frames; K1 "
                  f"{counts['K1']} on {card}")
        _write_seq(f"{tmp}/long/s2", float32_to_uint8(
            _smooth_frames(rng, SERVE_LONG_T, h, w)))
        try:
            serve.main([art, f"{tmp}/long", f"{tmp}/out_long", "--quiet"])
        except ValueError as e:
            _require("exceeds the artifact's fixed t" in str(e), str(e))
            print(f"serve: a {SERVE_LONG_T}-frame sequence refused by the "
                  f"{SERVE_ART_T}-frame artifact: {e}")
        else:
            raise RuntimeError("serve accepted a sequence longer than t")

    run, back, cfg = loaded["bf16"]
    from tecogan_tpu_torch.models.networks import (FRNet,
                                                   infer_sequence_batch)

    net = FRNet.from_state_dict(cfg, sd, device="cuda")
    fns = {"loaded bf16 artifact": lambda: run(back, x),
           "live infer_sequence_batch": lambda: infer_sequence_batch(
               net, x, cfg, chunk=SERVE_CHUNK)}
    fps = _in_turns(fns, f"1x{SERVE_T}x{h}x{w} 4x BD nf={NF} nb={NB} bf16 "
                    f"chunk={SERVE_CHUNK}", card)
    for k, fn in fns.items():
        _profile(fn, f"{k}, {SERVE_T} frames", card, ("warp_planes_kernel",))
    _k1_operator_cost(card)
    return launches, fps


def phase_profile_mode(card):
    """Phase 16: ``--mode profile --test_speed`` through the CLI in process
    on the shipped FRVSR Vimeo train.yml at 3x134x320, card 0: the analytic
    FLOPs and parameters of the JAX package's profile_frnet, the
    FlopCounterMode count, the FPS, K1 once per step (30 timed and the
    counted warm-up); then again with TECOGAN_TRACE_DIR, which must write
    a chrome trace. Returns K1's launches."""
    from tecogan_tpu_torch.main import main as cli_main

    yml = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       SHIPPED_FRVSR_VIMEO_YML)
    argv = ["--mode", "profile", "--opt", yml, "--gpu_ids", "0", "--lr_size",
            "3x134x320", "--test_speed"]
    with tempfile.TemporaryDirectory() as tmp:
        reset_kernel_launches()
        with _LogLines() as lines:
            out = cli_main(["--exp_dir", tmp, *argv])
        counts = kernel_launches()
        report = [ln for ln in "\n".join(lines).splitlines()
                  if ln.strip().startswith(("Resolution", "Module", "FLOPs",
                                            "Parameters", "Overall",
                                            "FlopCounterMode", "Speed"))]
        print("profile mode (the CLI's report):\n  " + "\n  ".join(report))
        _require(round(out["gflops"], 3) == 94.438
                 and out["params"] == 1745506 + 843587,
                 f"profile mode: {out['gflops']} GFLOPs, {out['params']} "
                 f"parameters; expected 94.438 and 2589093")
        _require(counts == {**dict.fromkeys(counts, 0), "K1": 31},
                 f"profile mode launches {counts}: expected K1 once per step "
                 f"(30 timed and the warm-up) and no other kernel")
        print(f"profile mode on {card}: analytic {out['gflops']:.3f} GFLOPs, "
              f"FlopCounterMode {out['counted_gflops']:.3f}, "
              f"{out['fps']:.2f} FPS (FRNet.step, fp32 with cuDNN's TF32 "
              f"default), K1 {counts['K1']}")
        os.environ["TECOGAN_TRACE_DIR"] = f"{tmp}/trace"
        try:
            traced = cli_main(["--exp_dir", tmp, *argv])
        finally:
            del os.environ["TECOGAN_TRACE_DIR"]
        trace = f"{tmp}/trace/profile_trace.json"
        with open(trace) as f:
            text = f.read()
        _require("warp_planes_kernel" in text,
                 "the profile trace holds no K1 kernel event")
        print(f"profile mode with TECOGAN_TRACE_DIR: a {len(text)}-byte "
              f"chrome trace with K1's kernel events; {traced['fps']:.2f} FPS "
              f"under the profiler")
    return counts["K1"]


def _lpips_weights(root, rng):
    """Backbones in torchvision's format (the port's trunks at torch's
    default initialisation from the seed) and v0.1 heads, as .pth files
    under root/pretrained_models/lpips, where LPIPS looks for them."""
    import torch

    from tecogan_tpu_torch.metrics import lpips

    d = os.path.join(root, "pretrained_models", "lpips")
    os.makedirs(d)
    for net, trunk in lpips._TRUNKS.items():
        bb_stem, lin_stem = lpips._NET_FILES[net]
        torch.manual_seed(SEED)
        torch.save(trunk().state_dict(), f"{d}/{bb_stem}.pth")
        torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
            rng.random((1, c, 1, 1), dtype=np.float32) * 0.1)
            for i, c in enumerate(lpips._NET_CHANS[net])},
            f"{d}/{lin_stem}.pth")
    return d


def phase_lpips(card):
    """Phase 17: LPIPS with weights made from the seed (.pth): the card
    against the CPU on 576x720 pairs for the AlexNet, VGG16 and SqueezeNet
    trunks (the AlexNet spatial map too), rtol 1e-4 in fp32 with TF32 off;
    test mode through the CLI with LPIPS in the metric stack (a BD set of
    2 x 12 frames of 576x720, as phase 5's), its LPIPS against a CPU
    recomputation from the PNGs; the official harness on those PNGs with
    LPIPS and tLP100, its LPIPS column against the metric calculator's;
    host and device seconds a frame of LPIPS beside PSNR's and SSIM's.
    Returns K1's launches in the CLI run."""
    import json as _json

    import torch

    from tecogan_tpu_torch.metrics.lpips import _NET_FILES, LPIPS
    from tecogan_tpu_torch.metrics.metric_calculator import MetricCalculator
    from tecogan_tpu_torch.official_metrics import evaluate
    from tecogan_tpu_torch.official_metrics.metrics import crop_32
    from tecogan_tpu_torch.ops.color import float32_to_uint8
    from tecogan_tpu_torch.utils.ckpt import save_pytree
    from tecogan_tpu_torch.utils.png import read_png

    rng = np.random.default_rng(SEED + 17)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        d = _lpips_weights(tmp, rng)
        gt = float32_to_uint8(_smooth_frames(rng, 2, *TM_GT))
        sr = np.clip(gt + rng.normal(0, 12.0, gt.shape), 0, 255).astype(
            np.uint8)
        for net, pairs, spatial in (("alex", 2, False), ("alex", 2, True),
                                    ("vgg", 1, False),
                                    ("squeeze", 1, False)):
            paths = [f"{d}/{stem}.pth" for stem in _NET_FILES[net]]
            on_card = LPIPS(net, *paths, spatial=spatial, device="cuda")
            on_cpu = LPIPS(net, *paths, spatial=spatial, device="cpu")
            a, b = on_card(gt[:pairs], sr[:pairs]), on_cpu(gt[:pairs],
                                                           sr[:pairs])
            err = float(np.max(np.abs(a - b) / np.abs(b).max()))
            ok = np.allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max())
            print(f"LPIPS {net}{' spatial' if spatial else ''} card vs CPU "
                  f"on {pairs} pair(s) of {TM_GT[0]}x{TM_GT[1]}: "
                  f"{np.round(a.reshape(pairs, -1)[:, 0], 6).tolist()} vs "
                  f"{np.round(b.reshape(pairs, -1)[:, 0], 6).tolist()}, "
                  f"max diff / max {err:.2e} (rtol 1e-4, atol 1e-6 x max): "
                  f"{'ok' if ok else 'FAIL'}")
            _require(ok and a.shape == b.shape, f"LPIPS {net} card vs CPU")

        # test mode with LPIPS in the metric stack, then the official
        # harness on its PNGs; cwd is the experiment, where both look for
        # pretrained_models/lpips, data/Vid4/GT and results/Vid4
        exp, yml, n_pad = _test_mode_opt(
            tmp, "lpips", {"type": "BD", "sigma": 1.5},
            {"gt_seq_dir": f"{tmp}/exp_lpips/data/Vid4/GT"},
            f"{tmp}/ckpt/FRVSR_BD_smoke.npz",
            {"PSNR": {"colorspace": "y"}, "SSIM": None,
             "LPIPS": {"net": "alex", "version": 0.1}})
        os.rename(os.path.join(tmp, "pretrained_models"),
                  os.path.join(exp, "pretrained_models"))
        os.makedirs(f"{tmp}/ckpt")
        save_pytree(_jax_layout_params(rng, NF, NB, SCALE),
                    f"{tmp}/ckpt/FRVSR_BD_smoke.npz")
        seqs = ("calendar", "city")
        for seq in seqs:
            _write_seq(f"{exp}/data/Vid4/GT/{seq}", float32_to_uint8(
                _smooth_frames(rng, TM_FRAMES, *TM_GT)))
        os.chdir(exp)
        try:
            reset_kernel_launches()
            records, secs, warns = _cli(exp, yml, "0")
            counts = kernel_launches()
            warped = len(seqs) * _frames_warped(TM_FRAMES + n_pad, 16)
            _require(not warns and counts == {**dict.fromkeys(counts, 0),
                                              "K1": warped},
                     f"test mode with LPIPS: warnings {warns}, launches "
                     f"{counts}")
            with open(f"{exp}/metrics/Vid4_avg.json") as f:
                avg = _json.load(f)["FRVSR_BD_smoke"]
            cpu = LPIPS(device="cpu")
            res = f"{exp}/results/Vid4/FRVSR_BD_smoke"
            per_seq = {}
            for seq in seqs:
                g = np.stack([read_png(f"{exp}/data/Vid4/GT/{seq}/{i:04d}.png")
                              for i in range(TM_FRAMES)])
                s = np.stack([read_png(f"{res}/{seq}/{i:04d}.png")
                              for i in range(TM_FRAMES)])
                per_seq[seq] = float(np.mean([cpu(g[i], s[i])[0]
                                              for i in range(TM_FRAMES)]))
            got = {r["seq_idx"]: r["metrics"]["LPIPS"] for r in records}
            want_avg = float(np.mean(list(per_seq.values())))
            ok = (all(np.isclose(got[k], v, rtol=1e-4, atol=0)
                      for k, v in per_seq.items())
                  and np.isclose(float(avg["LPIPS"]), want_avg, rtol=1e-4,
                                 atol=5e-7))
            print(f"test mode with LPIPS ({secs:.2f} s, K1 {counts['K1']}): "
                  f"per sequence {got} against the CPU from the PNGs "
                  f"{per_seq}; JSON average {avg['LPIPS']} against "
                  f"{want_avg:.6f} (rtol 1e-4): {'ok' if ok else 'FAIL'}")
            _require(ok, "test mode's LPIPS differs from the CPU's")

            summary = evaluate.main(["-m", "FRVSR_BD_smoke"])["Vid4"]
            _require("LPIPS" in summary and "tLP100" in summary,
                     f"the harness left out LPIPS: {list(summary)}")
            with open(f"{res}/metric_log/metrics.csv") as f:
                rows = [r.split(",") for r in f.read().splitlines()]
            calc = MetricCalculator({"metric": {"LPIPS": {"net": "alex"}},
                                     "device_ids": [0]})
            for fi, seq in enumerate(seqs):
                crops = [[crop_32(read_png(p))[0] for p in (
                    f"{exp}/data/Vid4/GT/{seq}/{i:04d}.png",
                    f"{res}/{seq}/{i:04d}.png")] for i in range(2, 10)]
                calc.compute_sequence_metrics(
                    seq, np.stack([c[0] for c in crops]),
                    np.stack([c[1] for c in crops]))
                start = [i for i, r in enumerate(rows)
                         if f"LPIPS_{fi:02d}" in r][0]
                col = rows[start].index(f"LPIPS_{fi:02d}")
                column = [np.float32(r[col]) for r in
                          rows[start + 1:start + 9]]
                want = np.float32(calc.metric_dict[seq]["LPIPS"]).tolist()
                _require(column == want, f"the harness's LPIPS column for "
                         f"{seq} {column} differs from the metric "
                         f"calculator's {want}")
            brief = {k: [v[0], round(v[1], 6)] for k, v in summary.items()}
            print(f"official harness on the test-mode PNGs (card): {brief}; "
                  f"its LPIPS columns equal the metric calculator's on the "
                  f"cropped frames")
        finally:
            os.chdir(cwd)

        # seconds a frame: host clock per metric on one sequence, and
        # LPIPS's device time per call
        g = np.stack([read_png(f"{exp}/data/Vid4/GT/calendar/{i:04d}.png")
                      for i in range(TM_FRAMES)])
        s = np.stack([read_png(f"{res}/calendar/{i:04d}.png")
                      for i in range(TM_FRAMES)])
        host = {}
        for m in ("PSNR", "SSIM", "LPIPS"):
            opt = {"metric": {m: {"net": "alex"} if m == "LPIPS" else None},
                   "device_ids": [0]}
            os.chdir(exp)
            try:
                calc = MetricCalculator(opt)
            finally:
                os.chdir(cwd)
            calc.compute_sequence_metrics("w", g[:2], s[:2])
            t0 = time.perf_counter()
            calc.compute_sequence_metrics("c", g, s)
            host[m] = (time.perf_counter() - t0) / TM_FRAMES
        lp = calc.lpips
        xa = torch.from_numpy(g[:1].transpose(0, 3, 1, 2).astype(
            np.float32) / 127.5 - 1).cuda()
        xb = torch.from_numpy(s[:1].transpose(0, 3, 1, 2).astype(
            np.float32) / 127.5 - 1).cuda()
        with torch.inference_mode():
            dev = _device_ms(lambda: lp.distance(xa, xb))
        print(f"metrics on {TM_FRAMES} frames of {TM_GT[0]}x{TM_GT[1]}, host "
              f"seconds a frame: PSNR {host['PSNR']:.4f}, SSIM "
              f"{host['SSIM']:.4f}, LPIPS {host['LPIPS']:.4f} (device "
              f"{_us(dev)} a frame; PSNR and SSIM run on the host) on {card}")
    return counts["K1"]


# ------------------------------------- K1 window, row sharding, data parallel

# row-sharded inference (phases 18-19): LR 512x960 -> 2048x3840 (4K), 8
# frames in one chunk, 2 and 4 shards on the one card
SP_LR, SP_FRAMES, SP_CHUNK, SP_SHARDS = (512, 960), 8, 8, (2, 4)
# fp32 sharded against unsharded: the JAX package's band
# (tests/test_sp_inference.py)
SP_F32_MAX_DIFF, SP_F32_FRAC = 1, 2e-4
# bf16 sharded against unsharded: the same band (measured on the card:
# bit-identical at k = 2 and 4, PERF.md section 6)
SP_BF16_MAX_DIFF, SP_BF16_FRAC = 1, 2e-4
# data parallel (phase 20): 2 ranks on the one card over gloo
DP_WORLD, DP_STEPS = 2, 3
# the fp32 two-rank step against one rank at the doubled batch: losses
# within rtol 1e-5 (sums in another order), each weight's Adam update
# within 5% of lr of the other's but for at most 2 elements (or 0.1% of
# the tensor), none beyond 4.2 lr (tests/test_torch_gan_step.py's rule);
# D's BatchNorm running stats within rtol 1e-5, atol 1e-6
DP_LOSS_RTOL, DP_BN_RTOL, DP_BN_ATOL = 1e-5, 1e-5, 1e-6
# each gradient tensor (averaged over the ranks) against one rank's at the
# doubled batch: relative L2 error 1e-3, phase 11's card-vs-CPU band; it
# also catches a gradient off by a factor, which Adam's first step (about
# lr times its sign) would hide. These GAN checks run with D's lr 0, as
# phase 13 does: G's losses and gradient read D after D's Adam step, and at
# D's shipped lr an element of D whose gradient sits at fp32's noise level
# steps either way (measured: G's conv_in gradient 2.1e-3 from one rank's,
# p_fake_G 1.4e-5 relative; PERF.md section 6). A second step at D's
# shipped lr holds D's Adam update to one rank's by the rule above.
DP_GRAD_REL = STEP_F32_GRAD_REL
# D's gradient: twice its fp32 distance from float64 (0.0122 relative in
# conv_in, phase 13's finding: train-mode BatchNorm's backward cancels most
# of it, so two fp32 sums in other orders differ by up to about twice
# that; measured here 1.37e-3 in conv_in, PERF.md section 6). With D's
# BatchNorm backward left on each rank (a fault planted once), D's
# gradient tensors read 0.245-1.36 and G's 0.031-0.108.
DP_D_GRAD_REL = 2.5e-2
# the CLI's store for its world-size-1 run over NCCL
DP_CLI_GT, DP_CLI_FRAMES = (240, 320), 12


def _window_case(gen, dev, hx, ho, ww, pd, fd, smooth, sigma):
    """Planes (1, 3, hx, ww) and the (1, ho, ww, 2) NHWC view of an NCHW
    flow, as the sharded path hands them to K1's window mode."""
    import torch

    planes = torch.randn((1, 3, hx, ww), generator=gen, device=dev).to(pd)
    if smooth:
        flow = _smooth_flow(gen, dev, 1, ho, ww, sigma)
    else:
        flow = torch.randn((1, 2, ho, ww), generator=gen, device=dev) * sigma
    return planes, flow.to(fd).permute(0, 2, 3, 1)


def phase_k1_window(card):
    """K1's window mode against warp_planes_window_reference on the card,
    bit for bit, at each of the sharded path's geometries (LR 512x960 on 2
    and on 4 shards: both border shards and an interior one; planes and
    flow f32/bf16; smooth and i.i.d. flow), and on the degenerate window
    against K1 itself. Returns its numbers at the interior shard of 4 (bf16,
    smooth flow)."""
    import torch
    import torch.nn.functional as F

    from tecogan_tpu_torch.models.networks import FRNetConfig
    from tecogan_tpu_torch.models.networks.frnet_sp import sp_geometry
    from tecogan_tpu_torch.ops.warp_cuda import (bilinear_taps, warp_planes,
                                                 warp_planes_reference,
                                                 warp_planes_window,
                                                 warp_planes_window_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    (h, w), s = SP_LR, SCALE
    ww = s * w

    def geometry(k):
        """The slab's and the output's rows, and shard j's window starts."""
        geo = sp_geometry(FRNetConfig(nf=NF, nb=NB, scale=SCALE), h, k)
        v, b2 = geo["v"], geo["b2"]
        return (s * v + 2 * b2, s * geo["l_sr"],
                lambda j: (s * geo["sr_start"][j], s * j * v - b2))

    n_cases, shapes = 0, []
    for k in SP_SHARDS:
        hx, ho, window = geometry(k)
        shapes.append(f"k={k}: slab {hx} rows, output {ho}, shards "
                      f"{sorted({0, 1, k - 1})}")
        for j in sorted({0, 1, k - 1}):
            out_y0, x_y0 = window(j)
            for pd in dts.values():
                for fd in dts.values():
                    for smooth, sigma in ((True, 6.0), (False, 30.0)):
                        planes, flow = _window_case(gen, dev, hx, ho, ww, pd,
                                                    fd, smooth, sigma)
                        torch.cuda.synchronize()
                        got = warp_planes_window(planes, flow, out_y0, x_y0,
                                                 s * h)
                        torch.cuda.synchronize()
                        ref = warp_planes_window_reference(
                            planes, flow, out_y0, x_y0, s * h)
                        err = float((got.float() - ref.float()).abs().max())
                        _require(torch.equal(got, ref),
                                 f"K1 window disagrees with its plain "
                                 f"version: shard {j} of {k}, planes {pd}, "
                                 f"flow {fd}, "
                                 f"{'smooth' if smooth else 'iid'} sigma "
                                 f"{sigma}, max abs err {err}")
                        n_cases += 1
    # the degenerate window is K1 itself
    for pd in dts.values():
        for smooth, sigma in ((True, 6.0), (False, 30.0)):
            planes, flow = _window_case(gen, dev, 536, 536, 1280, pd,
                                        torch.bfloat16, smooth, sigma)
            got = warp_planes_window(planes, flow, 0, 0, 536)
            _require(torch.equal(got, warp_planes(planes, flow))
                     and torch.equal(got, warp_planes_reference(planes,
                                                                flow)),
                     f"K1 window on the whole image differs from K1 "
                     f"(planes {pd})")
            n_cases += 1
    print(f"K1 window against its plain version: {n_cases} cases bit for "
          f"bit (width {ww}, h_glob {s * h}; {'; '.join(shapes)}; planes "
          f"and flow f32/bf16; smooth sigma 6 and i.i.d. sigma 30 flow; the "
          f"degenerate window equal to K1 at (1,3,536,1280))")

    k = max(SP_SHARDS)
    hx, ho, window = geometry(k)
    out_y0, x_y0 = window(1)
    planes, flow = _window_case(gen, dev, hx, ho, ww, torch.bfloat16,
                                torch.bfloat16, True, 6.0)
    # grid_sample on the slab, the global border emulated in the grid: the
    # sample row clamped in global rows, then moved into the slab
    ii = torch.arange(ho, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(ww, dtype=torch.float32, device=dev)[None, :]
    f = flow.float()
    gy = torch.clamp(out_y0 + ii + f[..., 1], 0, s * h - 1) - x_y0
    grid = torch.stack([(jj + f[..., 0]) * (2.0 / (ww - 1)) - 1.0,
                        gy * (2.0 / (hx - 1)) - 1.0], -1).bfloat16()
    # the bound's bytes: the slab rows this flow's taps touch, the flow
    # and the output
    y0, _, y1, _, _, _ = bilinear_taps(flow, ho, ww, out_y0=out_y0,
                                       h_glob=s * h)
    rows = torch.unique(torch.clamp(torch.cat([y0, y1]) - x_y0, 0, hx - 1))
    out = warp_planes_window(planes, flow, out_y0, x_y0, s * h)
    t = _time_kernel(
        f"K1 window time slab {tuple(planes.shape)} -> {tuple(out.shape)} "
        f"(shard 1 of {k}) bf16 planes+flow", card,
        lambda: warp_planes_window(planes, flow, out_y0, x_y0, s * h),
        lambda: warp_planes_window_reference(planes, flow, out_y0, x_y0,
                                             s * h),
        lambda: F.grid_sample(planes, grid, mode="bilinear",
                              padding_mode="border", align_corners=True),
        _bound("K1", (planes[:, :, :rows.numel()], flow), (out,),
               out[:, 0].numel(), 3))
    print(f"K1 window's bound counts {rows.numel()} of the slab's {hx} rows "
          f"(those the taps touch)")
    t["max_abs_err"] = 0.0
    return t


def _psnr_u8(a, b):
    d = (a.double() - b.double()).square().mean().item()
    return float("inf") if d == 0 else 10 * math.log10(255.0 ** 2 / d)


def phase_sp(card, params):
    """Row-sharded inference (infer_sequence_sp) at full width on 2 and 4
    shards of the one card against the unsharded infer_sequence on the same
    weights: 8 LR frames of 512x960 to 4K, fp32 (TF32 off, cuDNN
    deterministic) and bf16 to the JAX package's band; K1's
    window mode once per shard and frame, and K1 not at all; then the FPS
    of each in turns with its device idle share. Returns K1 window's
    launches in the checked runs."""
    import torch

    from tecogan_tpu_torch.models.convert import state_dict_from_jax
    from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                   infer_sequence,
                                                   infer_sequence_sp)
    from tecogan_tpu_torch.nn import inference_numerics

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 8)
    lr = torch.from_numpy(_smooth_frames(rng, SP_FRAMES, *SP_LR)).to(dev)
    sd = state_dict_from_jax(params, NB, SCALE)
    launches = 0
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = FRNetConfig(nf=NF, nb=NB, scale=SCALE, compute_dtype=dtype)
        net = FRNet.from_state_dict(cfg, sd, dev).to(cfg.dtype)
        with inference_numerics(dtype):
            ref = infer_sequence(net, lr, cfg, SP_CHUNK)
            for k in SP_SHARDS:
                torch.cuda.synchronize()
                reset_kernel_launches()
                got = infer_sequence_sp(net, lr, cfg, [dev] * k, SP_CHUNK)
                torch.cuda.synchronize()
                counts = kernel_launches()
                _require(counts == {**dict.fromkeys(counts, 0),
                                    "K1 window": SP_FRAMES * k},
                         f"sharded inference (k={k}, {dtype}): launches "
                         f"{counts}, expected K1 window once per shard and "
                         f"frame and no other kernel")
                launches += counts["K1 window"]
                mx, frac = _uint8_diff(got, ref)
                psnr = _psnr_u8(got, ref)
                print(f"row-sharded inference k={k} {dtype}, "
                      f"{SP_FRAMES}x{SP_LR[0]}x{SP_LR[1]} LR -> "
                      f"{tuple(got.shape)}: against unsharded max "
                      f"{mx} gray levels, {frac:.3e} of values differ, "
                      f"{psnr:.2f} dB; K1 window {counts['K1 window']} "
                      f"launches on {card}")
                _require(got.shape == ref.shape and got.dtype == torch.uint8,
                         f"sharded output {got.shape} {got.dtype}")
                band = ((SP_F32_MAX_DIFF, SP_F32_FRAC) if dtype == "float32"
                        else (SP_BF16_MAX_DIFF, SP_BF16_FRAC))
                _require(mx <= band[0] and frac <= band[1],
                         f"{dtype} sharded inference (k={k}) outside the "
                         f"band: max {mx}, {frac:.3e} differ")
        runs[dtype] = (net, cfg)

    net, cfg = runs["bfloat16"]
    fns = {"unsharded": lambda: infer_sequence(net, lr, cfg, SP_CHUNK)}
    for k in SP_SHARDS:
        fns[f"k={k}"] = (lambda k=k: infer_sequence_sp(net, lr, cfg,
                                                       [dev] * k, SP_CHUNK))
    times = {label: [] for label in fns}
    for rep in range(3):
        for label, fn in (fns.items() if rep % 2 == 0
                          else list(fns.items())[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    for label, fn in fns.items():
        wall, kernel_ms, events, _ = _device_totals(fn)
        idle = ("not measured" if kernel_ms is None
                else f"{1 - kernel_ms / wall:.3f}")
        print(f"FPS row-sharded ({label}) {SP_FRAMES}x{SP_LR[0]}x{SP_LR[1]} "
              f"-> 4x BD nf={NF} nb={NB} bf16 chunk {SP_CHUNK}, on one card: "
              f"{SP_FRAMES / min(times[label]):.2f} frames/s (min of 3: "
              f"{min(times[label]) * 1e3:.1f} ms; all "
              f"{[round(x * 1e3, 1) for x in times[label]]}); under the "
              f"profiler wall {wall:.1f} ms, kernels "
              f"{'not measured' if kernel_ms is None else f'{kernel_ms:.1f}'}"
              f" ms in {events} device events, device idle share {idle} on "
              f"{card}")
    return launches


def _dp_frvsr(out, mixed):
    """FRVSR steps on the Vimeo train.yml geometry (DP_STEPS in bf16, one
    in fp32) on this process's rows of global batches of DP_WORLD x
    TRAIN_BATCH clips (all of them outside a process group): the running
    logs after each step, the launches and each step's host ms (the step
    and the log's read back), and the weights and gradients (saved to
    ``out``)."""
    import torch

    from tecogan_tpu_torch.models import VSRModel
    from tecogan_tpu_torch.parallel import dist

    rng = np.random.default_rng(SEED + 9)
    size = 128 + 2 * int(1.5 * 3)
    batches = [_gt_clips(rng, TRAIN_BATCH * DP_WORLD, TRAIN_T, size)
               for _ in range(DP_STEPS if mixed else 1)]
    rows = dist.shard_rows(len(batches[0]), dist.rank(), dist.world())
    with tempfile.TemporaryDirectory() as d:
        opt = _train_opt(d)
        opt["train"]["mixed_precision"] = mixed
        # every rank on card 0: one id per rank
        opt["device_ids"] = [0] * dist.world()
        model = VSRModel(opt)
    reset_kernel_launches()
    logs, ms = [], []
    for gt in batches:
        t0 = time.perf_counter()
        model.train(model.prepare_training_data({"gt": gt[rows]}))
        logs.append(model.get_running_log(model.state))
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    counts = kernel_launches()
    torch.save({"g": model.net_g.state_dict(), "g_grad": _grads(model.net_g)},
               out)
    return logs, counts, ms


def _grads(net):
    """The gradients the last step left on ``net``'s parameters."""
    return {k: p.grad.detach().clone() for k, p in net.named_parameters()
            if p.grad is not None}


def _dp_gan(g_path, out, d_lr_zero):
    """One fp32 TecoGAN step on the shipped train.yml (adaptive vote), at
    D's lr 0 (see DP_GRAD_REL) or at its shipped lr, on this process's rows
    of a global batch of DP_WORLD x batch_size_per_gpu clips (all of them
    outside a process group): its logs, the launches, and G and D with their
    gradients and D's weights before the step (saved to ``out``)."""
    import torch

    from tecogan_tpu_torch.models import VSRGANModel
    from tecogan_tpu_torch.parallel import dist

    with tempfile.TemporaryDirectory() as d:
        opt = _gan_opt(d, g_path)
        opt["train"]["mixed_precision"] = False
        if d_lr_zero:
            opt["train"]["discriminator"]["lr"] = 0.0
        per = opt["dataset"]["train"]["batch_size_per_gpu"]
        size = opt["dataset"]["train"]["crop_size"] + 2 * int(1.5 * 3)
        gt = _gt_clips(np.random.default_rng(SEED + 10), per * DP_WORLD,
                       opt["train"]["tempo_extent"], size)
        gt = gt[dist.shard_rows(len(gt), dist.rank(), dist.world())]
        opt["device_ids"] = [0] * dist.world()
        model = VSRGANModel(opt)
    d_start = {k: v.clone() for k, v in model.net_d.state_dict().items()}
    reset_kernel_launches()
    logs = model.train(model.prepare_training_data({"gt": gt}))
    torch.cuda.synchronize()
    counts = kernel_launches()
    torch.save({"g": model.net_g.state_dict(), "d": model.net_d.state_dict(),
                "g_grad": _grads(model.net_g), "d_grad": _grads(model.net_d),
                "d_start": d_start}, out)
    return {k: float(v) for k, v in logs.items()}, counts


def _dp_worker(out_dir, g_path):
    """One rank of phase 20 (spawned with torchrun's environment): gloo on
    the card, its collectives on CUDA tensors; FRVSR in bf16 for DP_STEPS
    steps and in fp32 for one, one fp32 TecoGAN step at D's lr 0 and one at
    its shipped lr. Writes its results to out_dir/rank<r>.json."""
    import torch
    import torch.distributed as tdist

    from tecogan_tpu_torch.parallel import dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_distributed(dev, backend="gloo")
    rank = dist.rank()
    res = {"rank": rank, "world": dist.world(),
           "backend": tdist.get_backend()}
    # which collectives gloo takes on CUDA tensors
    t = torch.full((4,), float(rank + 1), device=dev)
    tdist.all_reduce(t)
    b = torch.full((4,), float(rank + 1), device=dev)
    tdist.broadcast(b, 0)
    res["cuda_all_reduce"], res["cuda_broadcast"] = t.tolist(), b.tolist()
    logs, counts, ms = _dp_frvsr(f"{out_dir}/frvsr_bf16_{rank}.pt", True)
    res.update(frvsr_bf16=logs, frvsr_bf16_counts=counts, frvsr_bf16_ms=ms)
    logs, counts, _ = _dp_frvsr(f"{out_dir}/frvsr_f32_{rank}.pt", False)
    res.update(frvsr_f32=logs, frvsr_f32_counts=counts)
    for key, d_lr_zero in (("gan", True), ("gan_lr", False)):
        logs, counts = _dp_gan(g_path, f"{out_dir}/{key}_{rank}.pt",
                               d_lr_zero)
        res.update({key: logs, f"{key}_counts": counts})
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(res, f)


def _cli_nccl_worker(exp, yml, out):
    """``--mode train`` through the CLI in a process with torchrun's
    environment at world size 1: its group over NCCL."""
    import torch.distributed as tdist

    from tecogan_tpu_torch.main import main as cli_main

    model = cli_main(["--exp_dir", exp, "--mode", "train", "--opt", yml,
                      "--gpu_ids", "0"])
    with open(out, "w") as f:
        json.dump({"backend": tdist.get_backend(),
                   "world": tdist.get_world_size(),
                   "step": model.state["step"],
                   "log": model.get_running_log(model.state)}, f)


def _grads_close(got, want, what, tol=None):
    """Each gradient tensor within relative L2 error ``tol`` (DP_GRAD_REL)
    of the other's; returns the largest error."""
    tol = DP_GRAD_REL if tol is None else tol
    worst = 0.0
    for k, v in want.items():
        v = v.float()
        err = float((got[k].float() - v).norm() / v.norm().clamp_min(1e-30))
        _require(err <= tol, f"{what} gradient of {k}: relative L2 error "
                 f"{err:.3e} against one rank's (tolerance {tol})")
        worst = max(worst, err)
    return worst


def _adam_close(got, want, start, lr, what):
    import torch

    start = torch.as_tensor(start).to(got.device, torch.float32)
    d = ((got.float() - start) - (want.float().to(got.device) - start)).abs()
    off = int((d > 0.05 * lr).sum())
    _require(off <= max(2, 1e-3 * d.numel()) and float(d.max()) <= 4.2 * lr,
             f"{what}: the two-rank Adam update differs from the one-rank "
             f"one ({off} of {d.numel()} elements off, max {float(d.max())})")
    return off


def _allclose(a, b, rtol, atol=0.0):
    return abs(a - b) <= atol + rtol * abs(b)


def phase_dp(card, params):
    """Data parallelism on the one card: 2 ranks spawned with torchrun's
    environment, gloo (NCCL refuses two ranks on one device) with every
    collective on CUDA tensors; the Vimeo FRVSR train.yml geometry (2 clips
    a rank x 10 frames, 128^2 crop) for DP_STEPS bf16 steps and one fp32
    step, and one fp32 TecoGAN step on the shipped train.yml under the
    adaptive vote at D's lr 0 (see DP_GRAD_REL) and one at its shipped lr.
    Requires: identical rank logs, weights and gradients; in fp32 the
    two-rank step equals one process's at the doubled batch (losses, each
    gradient tensor, FRVSR's and G's Adam updates at D's lr 0, D's
    BatchNorm running stats, the vote's distance, and D's Adam update at
    its shipped lr); the K2/K3+K4/K4 launches per rank those of the step's
    structure. Then the CLI trains 2 iterations at world size 1 over NCCL.
    Returns the launches of rank 0's steps."""
    import torch

    from tecogan_tpu_torch.data.records import RecordWriter
    from tecogan_tpu_torch.models.convert import state_dict_from_jax
    from tecogan_tpu_torch.ops.color import float32_to_uint8
    from tecogan_tpu_torch.parallel import dist
    from tecogan_tpu_torch.utils.ckpt import save_pytree
    from tecogan_tpu_torch.utils.yaml_subset import safe_dump

    with tempfile.TemporaryDirectory() as tmp:
        g_path = f"{tmp}/G_seed.npz"
        save_pytree(params, g_path)
        t0 = time.perf_counter()
        dist.spawn(_dp_worker, DP_WORLD, tmp, g_path)
        secs = time.perf_counter() - t0
        ranks = []
        for r in range(DP_WORLD):
            with open(f"{tmp}/rank{r}.json") as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        print(f"data parallel: {DP_WORLD} ranks spawned on {card} over "
              f"{r0['backend']} in {secs:.1f} s; all_reduce on CUDA "
              f"tensors {r0['cuda_all_reduce']}, broadcast "
              f"{r0['cuda_broadcast']}")
        _require(r0["cuda_all_reduce"] == [3.0] * 4
                 and r0["cuda_broadcast"] == [1.0] * 4
                 and ranks[1]["cuda_broadcast"] == [1.0] * 4,
                 "gloo's collectives on CUDA tensors gave wrong values")
        for key in ("frvsr_bf16", "frvsr_f32", "gan", "gan_lr"):
            _require(all(r[key] == r0[key] for r in ranks),
                     f"the ranks' {key} logs differ")
        nets = {}
        for key in ("frvsr_bf16", "frvsr_f32", "gan", "gan_lr"):
            nets[key] = [torch.load(f"{tmp}/{key}_{r}.pt")
                         for r in range(DP_WORLD)]
            a, b = nets[key]
            _require(all(torch.equal(a[n][k], b[n][k])
                         for n in a for k in a[n]),
                     f"the ranks' {key} weights or gradients differ")
        print(f"data parallel: rank logs, weights and gradients identical on "
              f"every rank "
              f"(FRVSR bf16 {DP_STEPS} steps: last {r0['frvsr_bf16'][-1]}; "
              f"TecoGAN vote distance {r0['gan']['distance']:.6f}, n_upd_D "
              f"{r0['gan']['n_upd_D']})")
        per = _expected_launches(TRAIN_T, True)
        gan_t = 2 * _gan_opt(tmp, g_path)["train"]["tempo_extent"] - 1
        per_gan = _gan_expected_launches(gan_t, True)
        for r in ranks:
            for key, steps, want in (("frvsr_bf16", DP_STEPS, per),
                                     ("frvsr_f32", 1, per),
                                     ("gan", 1, per_gan),
                                     ("gan_lr", 1, per_gan)):
                got = r[f"{key}_counts"]
                exp = {**dict.fromkeys(got, 0),
                       **{k: steps * v for k, v in want.items()}}
                _require(got == exp, f"rank {r['rank']} {key}: launches "
                         f"{got}, expected {exp}")
        print(f"data parallel: launches per rank equal the structure "
              f"(FRVSR {per} a step, TecoGAN {per_gan})")

        # one process at the global batch, bf16 (the step time) and fp32
        _, _, one_ms = _dp_frvsr(f"{tmp}/frvsr_bf16_one.pt", True)
        print(f"data parallel step time, bf16 FRVSR (Vimeo train.yml, "
              f"{TRAIN_T} frames of 128^2), host ms a step (train and log "
              f"read) after the first: {DP_WORLD} ranks sharing the one card "
              f"at {TRAIN_BATCH} clips each "
              f"{[[round(x, 2) for x in r['frvsr_bf16_ms'][1:]] for r in ranks]}"
              f"; one process at {DP_WORLD * TRAIN_BATCH} clips "
              f"{[round(x, 2) for x in one_ms[1:]]} on {card}")
        one_logs, _, _ = _dp_frvsr(f"{tmp}/frvsr_f32_one.pt", False)
        one = torch.load(f"{tmp}/frvsr_f32_one.pt")
        opt = _train_opt(tmp)
        start = _start_weights(opt)
        for k_, v in one_logs[0].items():
            _require(_allclose(r0["frvsr_f32"][0][k_], v, DP_LOSS_RTOL),
                     f"FRVSR fp32 {k_}: two ranks {r0['frvsr_f32'][0][k_]} "
                     f"against one rank {v}")
        lr_g = opt["train"]["generator"]["lr"]
        for k_, v in one["g"].items():
            _adam_close(nets["frvsr_f32"][0]["g"][k_], v, start[k_], lr_g,
                        f"FRVSR fp32 {k_}")
        rel = {"FRVSR": _grads_close(nets["frvsr_f32"][0]["g_grad"],
                                     one["g_grad"], "FRVSR fp32")}
        gan_one, _ = _dp_gan(g_path, f"{tmp}/gan_one.pt", True)
        g1 = torch.load(f"{tmp}/gan_one.pt")
        _require(gan_one["n_upd_D"] == r0["gan"]["n_upd_D"],
                 f"the vote differs: {gan_one['n_upd_D']} against "
                 f"{r0['gan']['n_upd_D']}")
        for k_, v in gan_one.items():
            _require(_allclose(r0["gan"][k_], v, DP_LOSS_RTOL, 1e-7),
                     f"TecoGAN fp32 {k_}: two ranks {r0['gan'][k_]} against "
                     f"one rank {v}")
        g_start = state_dict_from_jax(params, NB, SCALE)
        lr_g = _gan_opt(tmp, g_path)["train"]["generator"]["lr"]
        for k_, v in g1["g"].items():
            _adam_close(nets["gan"][0]["g"][k_], v, g_start[k_], lr_g,
                        f"TecoGAN fp32 G {k_}")
        for net, tol in (("g", DP_GRAD_REL), ("d", DP_D_GRAD_REL)):
            rel[f"TecoGAN {net.upper()}"] = _grads_close(
                nets["gan"][0][f"{net}_grad"], g1[f"{net}_grad"],
                f"TecoGAN fp32 {net}", tol)
        d2 = nets["gan"][0]["d"]
        for k_, v in g1["d"].items():
            if "running" in k_:
                _require(torch.allclose(d2[k_], v, rtol=DP_BN_RTOL,
                                        atol=DP_BN_ATOL),
                         f"D's {k_} differs from one rank's by "
                         f"{float((d2[k_] - v).abs().max())}")
        # at D's shipped lr, D's Adam update against one rank's
        gan_lr_one, _ = _dp_gan(g_path, f"{tmp}/gan_lr_one.pt", False)
        one_lr = torch.load(f"{tmp}/gan_lr_one.pt")
        _require(gan_lr_one["n_upd_D"] == r0["gan_lr"]["n_upd_D"] == 1.0,
                 f"at D's shipped lr the vote did not pass on both: "
                 f"{gan_lr_one['n_upd_D']}, {r0['gan_lr']['n_upd_D']}")
        lr_d = _gan_opt(tmp, g_path)["train"]["discriminator"]["lr"]
        off = {k_: _adam_close(nets["gan_lr"][0]["d"][k_], v,
                               one_lr["d_start"][k_], lr_d,
                               f"TecoGAN fp32 D {k_}")
               for k_, v in one_lr["d"].items()
               if "running" not in k_ and v.is_floating_point()}
        print(f"data parallel fp32 at D's shipped lr {lr_d}: D's Adam "
              f"update within the rule of one rank's at the doubled batch "
              f"(elements off by more than 5% of a step: {off}); "
              f"l_gan_D {r0['gan_lr']['l_gan_D']:.8f} vs "
              f"{gan_lr_one['l_gan_D']:.8f}, p_fake_G "
              f"{r0['gan_lr']['p_fake_G']:.8f} vs "
              f"{gan_lr_one['p_fake_G']:.8f} on {card}")
        print(f"data parallel fp32: two ranks against one at the doubled "
              f"batch: FRVSR losses {r0['frvsr_f32'][0]} vs {one_logs[0]}; "
              f"TecoGAN distance {r0['gan']['distance']:.8f} vs "
              f"{gan_one['distance']:.8f}, l_gan_D {r0['gan']['l_gan_D']:.8f}"
              f" vs {gan_one['l_gan_D']:.8f}, p_fake_G "
              f"{r0['gan']['p_fake_G']:.8f} vs {gan_one['p_fake_G']:.8f}; D's "
              f"BatchNorm running stats within rtol {DP_BN_RTOL}, atol "
              f"{DP_BN_ATOL}; FRVSR's and G's Adam updates within the rule; "
              f"the largest relative L2 error of a gradient tensor "
              f"{ {k: f'{v:.2e}' for k, v in rel.items()} } on {card}")

        # the CLI at world size 1 over NCCL
        rng = np.random.default_rng(SEED + 11)
        store = f"{tmp}/cli/GT.lmdb"
        w = RecordWriter(store)
        for vid in ("001", "002"):
            w.add_sequence(vid, float32_to_uint8(
                _smooth_frames(rng, DP_CLI_FRAMES, *DP_CLI_GT)))
        w.close()
        exp = f"{tmp}/cli/exp"
        os.makedirs(exp)
        yml = f"{exp}/train.yml"
        with open(yml, "w") as f:
            f.write(safe_dump(_frvsr_reds_opt(
                store, f"{tmp}/cli/none", total_iter=2, log_freq=1,
                ckpt_freq=2, test_freq=0)))
        t0 = time.perf_counter()
        dist.spawn(_cli_nccl_worker, 1, exp, yml, f"{tmp}/cli.json")
        with open(f"{tmp}/cli.json") as f:
            cli = json.load(f)
        print(f"CLI --mode train at world size 1: backend {cli['backend']}, "
              f"{cli['step']} iterations in {time.perf_counter() - t0:.1f} s "
              f"(process included), running log {cli['log']}")
        _require(cli["backend"] == "nccl" and cli["world"] == 1
                 and cli["step"] == 2
                 and all(math.isfinite(v) for v in cli["log"].values())
                 and sorted(os.listdir(f"{exp}/train/ckpt")) == [
                     "G_iter2.npz", "state_iter2.pth"],
                 f"the CLI's NCCL run: {cli}")
    return {k: r0["frvsr_bf16_counts"][k] + r0["frvsr_f32_counts"][k]
            + r0["gan_counts"][k] + r0["gan_lr_counts"][k]
            for k in ("K2", "K3", "K3+K4", "K4")}


# ------------------------------------------------------------ bench entry

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
BENCH_RUNS = 6  # bench_torch.py: one warm-up and 5 timed runs


def phase_bench(card):
    """``python3 bench_torch.py`` in a subprocess, as a user runs it: its
    last line one JSON object with bench.py's four keys, the port's metric
    name and a finite FPS > 0, its K1 launches one per warped frame of its
    runs; then the perf canary (``tools/bench_suite.check_canary``) in
    process against ``tools/perf_canary.json``, which must pass. Returns
    the canary's launches (its FPS row: K1; its FRVSR and TecoGAN rows:
    K2, K3, K3+K4, K4)."""
    from tecogan_tpu_torch.tools import bench_suite

    root = os.path.dirname(os.path.abspath(__file__))
    start = t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "bench_torch.py"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    _require(res.returncode == 0,
             f"bench_torch.py exited {res.returncode}: {res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    print(f"bench_torch.py ({secs:.1f} s with its process): "
          f"{lines[-1]}; {lines[0]}")
    _require(set(line) == BENCH_KEYS
             and line["metric"] == "torch_4x_bd_sr_fps_134x320"
             and math.isfinite(line["value"]) and line["value"] > 0,
             f"bench_torch.py's line: {line}")
    k1 = int(next(ln for ln in lines
                  if ln.startswith("warp_planes launches:")).split(":")[1])
    _require(k1 == BENCH_RUNS * _frames_warped(64, 64),
             f"bench_torch.py launched K1 {k1} times, expected "
             f"{BENCH_RUNS * _frames_warped(64, 64)}")
    reset_kernel_launches()
    table = io.StringIO()
    with contextlib.redirect_stdout(table):
        ok = bench_suite.check_canary()
    counts = kernel_launches()
    print(table.getvalue(), end="")
    print(f"perf canary launches: {counts}; phase 21 took "
          f"{time.perf_counter() - start:.1f} s on {card}")
    _require(ok, "the perf canary failed (tools/perf_canary.json):\n"
             + table.getvalue())
    for key in ("K1", "K2", "K3+K4", "K4"):
        _require(counts[key] > 0, f"the canary launched no {key}")
    return counts

# phase 22: the synthetic campaign at full width (nf=64, nb=10, crop 128,
# batch 4, tempo 10, bf16), depth cut: 8 training clips of 16 frames at
# 192^2, 2 held-out sequences of 10 frames at 256x448, FRVSR 16 iterations,
# TecoGAN 8
CAMPAIGN_DATA = dict(n_train=8, t_train=16, hw_train=(192, 192), n_test=2,
                     t_test=10, hw_test=(256, 448))
CAMPAIGN_ITERS = (16, 8)
# the warps of the batch of 4: HR frames, the fake STNet assembly's end
# slots (ASSEMBLY_WARP_SHAPE at batch 4), the warping loss's LR pairs (4 x 9
# in FRVSR, 4 x 18 after TecoGAN's ping-pong)
CAMPAIGN_HR_SHAPE = (4, 3, 128, 128)
CAMPAIGN_ASSEMBLY_SHAPE = (48, 3, 128, 128)
CAMPAIGN_LR_PAIR_SHAPES = ((36, 3, 32, 32), (72, 3, 32, 32))
# infer_streams: streams x frames of LR, bf16
STREAMS_SHAPE = (4, 16, 134, 320)


def _campaign_kernels():
    """The kernels at the campaign's shapes, bit for bit their plain
    versions, image and flow f32/bf16, smooth-ish and wide flows: K1 at the
    eval's fp32 call (1,3,256,448); K2 and K3+K4 at the HR warps of the
    batch of 4 (4,3,128,128); K3 alone at TecoGAN's fake STNet assembly
    (CAMPAIGN_ASSEMBLY_SHAPE, more passes of its cooperative grid than
    phase 12 holds); K2 and K4 alone at the warping loss's LR pairs of
    FRVSR and TecoGAN (CAMPAIGN_LR_PAIR_SHAPES)."""
    import torch

    from tecogan_tpu_torch.ops.warp_cuda import (stride_grid, tile_plan,
                                                 warp_planes,
                                                 warp_planes_reference,
                                                 warp_rgb)
    from tecogan_tpu_torch.ops.warp_vjp import (_dimage_slots,
                                                dimage_resident_blocks,
                                                warp_dflow,
                                                warp_dflow_reference,
                                                warp_dimage,
                                                warp_dimage_dflow,
                                                warp_dimage_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    dts = (torch.float32, torch.bfloat16)
    counts = dict.fromkeys(("K1", "K2", "K3", "K3+K4", "K4"), 0)

    def inputs(shape, xd, fd, sigma):
        n, c, h, w = shape
        x = torch.rand(shape, generator=gen, device=dev).to(xd)
        g = torch.randn(shape, generator=gen, device=dev).to(xd)
        fl = _vjp_flow(gen, dev, n, h, w, sigma).to(fd)
        return x, g, fl, f"{shape} x={xd} flow={fd} sigma={sigma}"

    for sigma in (6.0, 30.0, 300.0):
        planes = torch.randn((1, 3, 256, 448), generator=gen, device=dev)
        flow = (torch.randn((1, 2, 256, 448), generator=gen, device=dev)
                * sigma).permute(0, 2, 3, 1)
        got = warp_planes(planes, flow)
        torch.cuda.synchronize()
        _require(torch.equal(got, warp_planes_reference(planes, flow)),
                 f"K1 at (1,3,256,448) fp32 sigma={sigma} differs from its "
                 f"plain version")
        counts["K1"] += 1
        for xd in dts:
            for fd in dts:
                x, g, fl, tag = inputs(CAMPAIGN_HR_SHAPE, xd, fd, sigma)
                got = warp_rgb(x, fl)
                dx, df = warp_dimage_dflow(g, x, fl)
                torch.cuda.synchronize()
                _require(_equal(got, warp_planes_reference(x, fl)),
                         f"K2 differs from its plain version: {tag}")
                _require(_equal((dx, df), (warp_dimage_reference(g, fl, xd),
                                           warp_dflow_reference(g, x, fl))),
                         f"K3+K4 differs from its plain versions: {tag}")
                counts["K2"] += 1
                counts["K3+K4"] += 1
                x, g, fl, tag = inputs(CAMPAIGN_ASSEMBLY_SHAPE, xd, fd, sigma)
                got = warp_dimage(g, fl, xd)
                torch.cuda.synchronize()
                _require(_equal(got, warp_dimage_reference(g, fl, xd)),
                         f"K3 alone differs from its plain version: {tag}")
                counts["K3"] += 1
                for shape in CAMPAIGN_LR_PAIR_SHAPES:
                    x, g, fl, tag = inputs(shape, xd, fd, sigma)
                    got = warp_rgb(x, fl)
                    df = warp_dflow(g, x, fl)
                    torch.cuda.synchronize()
                    _require(_equal(got, warp_planes_reference(x, fl)),
                             f"K2 differs from its plain version: {tag}")
                    _require(_equal(df, warp_dflow_reference(g, x, fl)),
                             f"K4 alone differs from its plain version: "
                             f"{tag}")
                    counts["K2"] += 1
                    counts["K4"] += 1
    n, c, h, w = CAMPAIGN_ASSEMBLY_SHAPE
    resident = dimage_resident_blocks("tecogan_warp_dimage_bf16_bf16_bf16",
                                      0, c)
    grid = stride_grid(n, c, h, w, min(resident, _dimage_slots(0)))
    tiles, _ = tile_plan(n, h, w, steps=1)
    passes = math.prod(-(-t // g) for t, g in zip(tiles, grid))
    print(f"campaign shapes, {sum(counts.values())} cases bit for bit their "
          f"plain versions ({counts}): K1 (1,3,256,448) fp32; K2 and K3+K4 "
          f"{CAMPAIGN_HR_SHAPE}; K3 alone {CAMPAIGN_ASSEMBLY_SHAPE} (bf16: "
          f"{resident} co-resident blocks, grid {grid} over tiles {tiles}, "
          f"{passes} passes); K2 and K4 alone {CAMPAIGN_LR_PAIR_SHAPES}")


def _cli_launches(log_path):
    """The ``kernel launches: {...}`` line the CLI logs at its end."""
    with open(log_path) as f:
        lines = [ln for ln in f if "kernel launches: " in ln]
    _require(len(lines) == 1, f"{log_path}: {len(lines)} launch lines")
    return json.loads(lines[0].split("kernel launches: ", 1)[1])


def _campaign_stages(rsc, wd):
    """Phase 22's stages in ``wd`` and their checks. Returns the summary,
    the CLIs' launches and each stage's seconds."""
    base_opt = rsc._base_opt

    def every_iteration(*a, **k):
        # every iteration logged, two validations a run (the recipe's
        # cadence, 8 and 6 a run, cut with the depth)
        opt = base_opt(*a, **k)
        opt["logger"]["log_freq"] = 1
        opt["test"]["test_freq"] = opt["train"]["total_iter"] // 2
        return opt

    fr_iter, gan_iter = CAMPAIGN_ITERS
    total, stages = {}, {}
    rsc._base_opt = every_iteration

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        stages[name] = round(time.perf_counter() - t0, 1)
        return res

    try:
        timed("data", rsc.stage_data, wd, **CAMPAIGN_DATA)
        fr_ckpt = timed("frvsr", rsc.stage_frvsr, wd, fr_iter)
        gan_ckpt = timed("tecogan", rsc.stage_tecogan, wd, fr_ckpt,
                         gan_iter)
        summary = timed("eval", rsc.stage_eval, wd, fr_iter, gan_iter)
    finally:
        rsc._base_opt = base_opt
    gan_dir = os.path.dirname(gan_ckpt)
    for path in (fr_ckpt, gan_ckpt,
                 os.path.join(gan_dir, f"D_iter{gan_iter}.npz"),
                 os.path.join(wd, "eval", "summary.json")):
        _require(os.path.exists(path), f"campaign: no {path}")
    n_test, t_test = CAMPAIGN_DATA["n_test"], CAMPAIGN_DATA["t_test"]
    want = {"PSNR": n_test * (t_test - 4), "SSIM": n_test * (t_test - 4),
            "tOF": n_test * (t_test - 5)}
    _require(sorted(summary) == sorted(
        ["bicubic", "FRVSR_Synth_4xSR", "TecoGAN_Synth_4xSR"]),
        f"campaign summary rows {sorted(summary)}")
    for row, metrics in summary.items():
        _require({k: v["frames"] for k, v in metrics.items()} == want
                 and all(math.isfinite(v["frame_avg"])
                         for v in metrics.values()),
                 f"campaign {row}: {metrics}, frames expected {want}")
    # K1 per frame warped: each 10-frame sequence with its 5 padding
    # frames, in every validation and in each test run
    t = _frames_warped(t_test + 5, 16)
    per = {"FRVSR": (_expected_launches(10, True), fr_iter),
           "TecoGAN": (_gan_expected_launches(19, True), gan_iter)}
    for name, (per_iter, iters) in per.items():
        exp = os.path.join(wd, f"{name}_Synth_4xSR")
        with open(os.path.join(exp, "train.log")) as f:
            logs = _train_log_lines(
                [ln.split("[INFO]: ", 1)[-1].rstrip("\n") for ln in f])
        _require([it for _, it, *_ in logs] == list(range(1, iters + 1))
                 and all(math.isfinite(v) for *_, lg in logs
                         for v in lg.values()),
                 f"campaign {name}: the losses of {len(logs)} log lines "
                 f"({[lg for *_, lg in logs[-2:]]})")
        counts = _cli_launches(os.path.join(exp, "train.log"))
        want = {**dict.fromkeys(counts, 0), "K1": 2 * n_test * t,
                **{k: iters * per_iter[k]
                   for k in ("K2", "K3", "K3+K4", "K4")}}
        _require(counts == want, f"campaign {name} train: launches "
                 f"{counts}, expected {want}")
        tested = _cli_launches(os.path.join(wd, "eval",
                                            f"{name}_Synth_4xSR",
                                            "test.log"))
        _require(tested == {**dict.fromkeys(tested, 0), "K1": n_test * t},
                 f"campaign {name} test: launches {tested}")
        for key, count in counts.items():
            total[key] = total.get(key, 0) + count + tested[key]
    return summary, total, stages


def phase_campaign(card, params):
    """The synthetic campaign (``tools/run_synth_campaign.py``) through its
    stage functions, each CLI a subprocess on the card: data, FRVSR from the
    seed, TecoGAN warm-started from it, eval (bicubic baseline, test mode of
    both models, the official harness). Requires every stage's artifacts,
    the harness's frame counts, finite losses on every iteration's log line
    (the phase logs every iteration), each CLI's launches equal to its
    structure; then ``infer_streams`` on [0, 0] bit for bit
    ``infer_sequence_batch``. Returns the launches of both."""
    import torch

    from tecogan_tpu_torch.models.convert import state_dict_from_jax
    from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                                   infer_sequence_batch)
    from tecogan_tpu_torch.parallel import infer_streams
    from tecogan_tpu_torch.tools import run_synth_campaign as rsc

    start = time.perf_counter()
    _campaign_kernels()
    with tempfile.TemporaryDirectory() as wd, contextlib.redirect_stdout(
            io.StringIO()) as out:
        try:
            summary, total, stages = _campaign_stages(rsc, wd)
        except Exception:
            # the stages' output, the harness's included, goes with the
            # workdir otherwise
            print(out.getvalue()[-4000:], file=sys.stderr)
            raise
    print(out.getvalue()[-1500:], end="")
    print(f"campaign summary: {json.dumps(summary)}")
    print(f"campaign launches (FRVSR {CAMPAIGN_ITERS[0]} + TecoGAN "
          f"{CAMPAIGN_ITERS[1]} iterations, validations and test runs, in "
          f"the CLI processes): {total}; the stages took {stages} s on "
          f"{card}")

    # the stream split: 4 streams in 2 blocks on the one card
    cfg = FRNetConfig(nf=NF, nb=NB, scale=SCALE, degradation="BD",
                      compute_dtype="bfloat16")
    net = FRNet.from_state_dict(cfg, state_dict_from_jax(params, NB, SCALE),
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    n, t, h, w = STREAMS_SHAPE
    lr = torch.rand((n, t, h, w, 3), generator=gen, device="cuda")
    want = infer_sequence_batch(net, lr, cfg, chunk=16)
    reset_kernel_launches()
    got = infer_streams(net, lr, cfg, [0, 0], chunk=16)
    torch.cuda.synchronize()
    counts = kernel_launches()
    _require(got.shape == want.shape and torch.equal(got, want),
             f"infer_streams on [0, 0] differs from infer_sequence_batch: "
             f"{_uint8_diff(got, want)}")
    # K1 warps a block's streams together: once per block and frame
    _require(counts == {**dict.fromkeys(counts, 0), "K1": 2 * t},
             f"infer_streams launches {counts}, expected K1 {2 * t}")
    print(f"infer_streams on [0, 0], {n} x {t} frames of {h}x{w} bf16: "
          f"bit-identical to infer_sequence_batch, K1 {counts['K1']} "
          f"launches; phase 22 took {time.perf_counter() - start:.1f} s")
    total["K1"] += counts["K1"]
    return total


def _start_weights(opt):
    """The generator a VSRModel draws from ``opt``'s seed, on the card."""
    import torch

    from tecogan_tpu_torch.models.networks import define_generator

    _, build = define_generator(opt)
    gen = torch.Generator().manual_seed(opt["manual_seed"])
    return build(gen, "cuda").state_dict()


# BasicVSR++'s shapes: 4 clips of LR 180x320 (REDS4), 64 channels, 16
# deformable groups
BVPP_N, BVPP_LR, BVPP_M, BVPP_G = 4, (180, 320), 64, 16


def _dcn_case(gen, dev, n, h, w, m, groups, dtype, sigma=4.0):
    """A DCN's operands at BasicVSR++'s layout: x (n, 2m, h, w) and raw (n,
    27 groups, h, w) channels_last in ``dtype``, two smooth fp32 flows of
    about ``sigma`` pixels (some samples leave the frame)."""
    import torch

    x = torch.randn((n, 2 * m, h, w), generator=gen, device=dev).to(
        dtype, memory_format=torch.channels_last)
    raw = torch.randn((n, 27 * groups, h, w), generator=gen,
                      device=dev).to(dtype, memory_format=torch.channels_last)
    flows = [_smooth_flow(gen, dev, n, h, w, sigma) for _ in range(2)]
    return x, raw, flows


def _dcn_library(x, raw, f1, f2, weight, bias, mag, groups):
    """The DCN composed of library calls, a yardstick only: the offsets and
    the mask, one ``F.grid_sample`` (zeros, align_corners=True) of every
    group at its nine taps, the mask, and ``torch.addmm``."""
    import torch
    import torch.nn.functional as F

    n, c, h, w = x.shape
    cg = c // groups
    r = raw.float()
    half = groups // 2
    fl = torch.cat([f1[:, None].expand(n, half, 2, h, w),
                    f2[:, None].expand(n, groups - half, 2, h, w)], 1)
    dy = mag * torch.tanh(r[:, 0:18 * groups:2].reshape(n, groups, 9, h, w)) \
        + fl[:, :, None, 1]
    dx = mag * torch.tanh(r[:, 1:18 * groups:2].reshape(n, groups, 9, h, w)) \
        + fl[:, :, None, 0]
    k = torch.arange(9, device=x.device)
    sy = (torch.arange(h, device=x.device)[:, None] + k[:, None, None] // 3
          - 1) + dy
    sx = (torch.arange(w, device=x.device)[None, :] + k[:, None, None] % 3
          - 1) + dx
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0],
                       -1).reshape(n * groups, 9 * h, w, 2)
    val = F.grid_sample(x.reshape(n * groups, cg, h, w).float(), grid,
                        padding_mode="zeros", align_corners=True)
    val = val.reshape(n, groups, cg, 9, h, w) * torch.sigmoid(
        r[:, 18 * groups:].reshape(n, groups, 1, 9, h, w))
    col = val.permute(0, 4, 5, 3, 1, 2).reshape(n * h * w, 9 * c).to(x.dtype)
    wt = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).t()
    return torch.addmm(bias, col, wt)


def phase_dcn(card):
    """K1's zero padding and the DCN's column gather against their plain
    versions on the card at BasicVSR++'s shapes, each timed beside its
    bound, its plain version and a library yardstick. Returns their
    numbers."""
    import torch
    import torch.nn.functional as F

    from tecogan_tpu_torch.ops import dcn as dcn_ops
    from tecogan_tpu_torch.ops.warp_cuda import (warp_zero,
                                                 warp_zero_reference)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    n, (h, w), m, groups = BVPP_N, BVPP_LR, BVPP_M, BVPP_G
    out = {}
    # K1 zero: a 64-channel bf16 channels_last feature map and a 2-channel
    # fp32 flow, each along a smooth fp32 flow of 4 and of 30 pixels
    for sigma in (4.0, 30.0):
        flow = _smooth_flow(gen, dev, n, h, w, sigma).permute(0, 2, 3, 1)
        feat = torch.randn((n, m, h, w), generator=gen, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        fl2 = torch.randn((n, 2, h, w), generator=gen, device=dev)
        for img in (feat, fl2):
            got = warp_zero(img, flow)
            torch.cuda.synchronize()
            want = warp_zero_reference(img, flow)
            lib = F.grid_sample(img.float(), _grid(flow, torch.float32),
                                padding_mode="zeros", align_corners=True)
            _require(torch.equal(got, want) and got.stride() == img.stride(),
                     f"K1 zero disagrees with its plain version ({img.dtype}, "
                     f"sigma {sigma}): max abs err "
                     f"{float((got.float() - want.float()).abs().max())}")
            lib_err = float((got.float() - lib).abs().max())
            # grid_sample's normalised coordinates move a sample point by
            # ulps of W (about 3e-5 px at W 320), times the image's slope;
            # bf16 rounds the output to 8 bits
            tol = (1e-3 if img.dtype == torch.float32 else 2 ** -7) * float(
                lib.abs().max())
            _require(lib_err <= tol, f"K1 zero against grid_sample: "
                     f"{lib_err} over {tol}")
            print(f"K1 zero ({tuple(img.shape)} {img.dtype}, sigma {sigma}): "
                  f"bit-identical to its plain version; grid_sample max abs "
                  f"err {lib_err:.3g}")
    feat_bytes = 2 * feat.numel() * feat.element_size() + flow.numel() * 4
    t = _time_kernel(
        "K1 zero (4,64,180,320) bf16", card, lambda: warp_zero(feat, flow),
        lambda: warp_zero_reference(feat, flow),
        lambda: F.grid_sample(feat, _grid(flow, torch.bfloat16),
                              padding_mode="zeros", align_corners=True),
        (feat_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    out["K1 zero"] = dict(t, max_abs_err=0.0)

    # the DCN: columns bit-near the plain version (tanhf and expf are
    # CUDA's: a sample point may move by an ulp), in both load paths
    weight = (torch.randn((m, 2 * m, 3, 3), generator=gen, device=dev)
              / 34.0).to(torch.bfloat16, memory_format=torch.channels_last)
    bias = (torch.randn((m,), generator=gen, device=dev) / 34.0).bfloat16()
    x, raw, (f1, f2) = _dcn_case(gen, dev, n, h, w, m, groups, torch.bfloat16)
    for label, xx, rr in (("bf16 channels_last", x, raw),
                          ("fp32 NCHW", x[:1].float().contiguous(),
                           raw[:1].float().contiguous())):
        ff = (f1[:len(xx)], f2[:len(xx)])
        got = dcn_ops.dcn_columns(xx, rr, *ff, 10.0, groups)
        torch.cuda.synchronize()
        want = dcn_ops.dcn_columns_reference(xx, rr, *ff, 10.0, groups)
        err = (got.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        tol = 1e-4 * scale if xx.dtype == torch.float32 else 2 ** -7 * scale
        bad = float((err > tol).float().mean())
        print(f"DCN columns {label} {tuple(xx.shape)}: max abs err "
              f"{float(err.max()):.3g} (values to {scale:.3g}), share over "
              f"{tol:.3g}: {bad:.3g}")
        _require(bad < 1e-5, f"DCN columns ({label}) disagree with their "
                 f"plain version: {bad} of the values over {tol}")
    dcn = lambda: dcn_ops.modulated_deform_conv(x, raw, f1, f2, weight, bias,
                                                10.0, groups)
    lib_out = _dcn_library(x, raw, f1, f2, weight, bias, 10.0, groups)
    got = dcn().reshape(n, m, h * w).transpose(1, 2).reshape(-1, m)
    lib_err = float((got.float() - lib_out.float()).abs().max())
    print(f"DCN against its library composition: max abs err {lib_err:.3g} "
          f"(outputs to {float(lib_out.float().abs().max()):.3g})")
    nbytes = (n * h * w * ((2 * m + 27 * groups + m) * 2 + 16)
              + weight.numel() * 2 + m * 2)
    flops = 2 * n * h * w * 2 * m * 9 * m
    bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                (flops / 989e12 * 1e3, "bf16 FLOPs"))
    t = _time_kernel(
        "DCN (4,128,180,320) bf16", card, dcn,
        lambda: dcn_ops.dcn_columns_reference(x, raw, f1, f2, 10.0, groups)
        @ weight.permute(0, 2, 3, 1).reshape(m, -1).t(),
        lambda: _dcn_library(x, raw, f1, f2, weight, bias, 10.0, groups),
        bound)
    cols = lambda: dcn_ops.dcn_columns(x, raw, f1, f2, 10.0, groups)
    t["columns_device_ms"] = _device_ms(cols)
    print(f"DCN column gather alone: device {_us(t['columns_device_ms'])}")
    out["DCN"] = dict(t, max_abs_err=lib_err)
    return out


def phase_basicvsrpp(card):
    """BasicVSR++ through ``infer_clip_batch`` on the card against the
    plain reference (``vsrbench/reference/basicvsrpp.py``) at the published
    widths on 2 clips of 8 frames of 64x96, fp32 (TF32 off) and bf16, with
    its launch counts. Returns the counts."""
    import torch

    from tecogan_tpu_torch import ops
    from tecogan_tpu_torch.models.networks import (BasicVSRPP,
                                                   BasicVSRPPConfig,
                                                   infer_clip_batch)
    from tecogan_tpu_torch.nn import inference_numerics
    from vsrbench import weights
    from vsrbench.drivers.infer_clips import moving_textures
    from vsrbench.reference import basicvsrpp as ref
    from vsrbench.reference.train import no_tf32

    dev = torch.device("cuda", 0)
    gen = weights.generator(SEED + 13, dev)
    n, t, h, w = 2, 8, 64, 96
    sd = weights.random_state(weights.layout(ref.BasicVSRPlusPlus), gen, dev)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "vsrbench", "configs",
                           "basicvsrpp_4x_reds.json")) as f:
        scale = json.load(f)["draw_scale"]  # the benchmark's draw
    for k, v in sd.items():
        for suffix, s in scale.items():
            if k.endswith(suffix):
                v.mul_(s)
    lr = moving_textures({"streams": n, "frames": t, "height": h, "width": w,
                          "waves": 8, "max_freq": 0.12, "max_speed": 2.5},
                         gen, dev)
    net_ref = ref.BasicVSRPlusPlus().to(dev).eval()
    net_ref.load_state_dict(sd)
    with no_tf32():
        want = net_ref.infer(lr)
    launches = {}
    for dt, limit in (("float32", 0.001), ("bfloat16", 0.1)):
        cfg = BasicVSRPPConfig(compute_dtype=dt)
        net = BasicVSRPP.from_state_dict(cfg, sd, dev).to(cfg.dtype)
        before = ops.kernel_launches()
        with inference_numerics(dt):
            got = infer_clip_batch(net, lr, cfg, chunk=4)
        torch.cuda.synchronize()
        after = ops.kernel_launches()
        d = (got.int() - want.int()).abs().float()
        worst = float(d.mean(dim=(2, 3, 4)).max())
        counts = {k: after[k] - before[k] for k in ("K1", "K1 zero", "DCN")}
        print(f"BasicVSR++ {dt} (2 clips x 8 frames of 64x96, 64 channels, "
              f"7 blocks) against the reference: worst frame's mean "
              f"{worst:.4g} gray levels, max {float(d.max()):.0f}; "
              f"launches {counts} on {card}")
        _require(worst <= limit, f"BasicVSR++ {dt} departs from the "
                 f"reference: {worst} over {limit}")
        # the DCN once per aligned step of each branch; K1 zero 1 + 3 a
        # step after the second; K1 at SPyNet's 6 levels, both directions,
        # one pass per chunk of 4 pairs
        _require(counts["DCN"] == 4 * (t - 1)
                 and counts["K1 zero"] == 4 * (1 + 3 * (t - 2))
                 and counts["K1"] == 2 * 6 * -(-(t - 1) // 4),
                 f"BasicVSR++ launches {counts}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    return launches


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
             "K5": phase_k5(card), "K1 window": phase_k1_window(card)}
    times.update(phase_dcn(card))
    bvpp_launches = phase_basicvsrpp(card)

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
    launches["K1 window"] = phase_sp(card, params)
    launches["K1"] += bvpp_launches["K1"]
    launches["K1 zero"] = bvpp_launches["K1 zero"]
    launches["DCN"] = bvpp_launches["DCN"]

    times.update(phase_k234(card))
    phase_assembly_warps(card)
    launches.update(phase_train(rng, card))
    phase_train_card_vs_cpu(sd, rng)
    for key, count in phase_gan_train(rng, card).items():
        launches[key] += count
    gan_case = _d_band_case(sd)
    phase_gan_card_vs_cpu(sd, rng, gan_case[2])
    phase_f32_conv_audit(card, sd, gan_case)
    for key, count in phase_train_mode(card).items():
        launches[key] += count
    serve_launches, _ = phase_serving(card, params)
    for key, count in serve_launches.items():
        launches[key] += count
    launches["K1"] += phase_profile_mode(card)
    launches["K1"] += phase_lpips(card)
    for key, count in phase_dp(card, params).items():
        launches[key] += count
    for key, count in phase_bench(card).items():
        launches[key] += count
    for key, count in phase_campaign(card, params).items():
        launches[key] += count

    _require("jax" not in sys.modules and "yaml" not in sys.modules,
             "jax or yaml was imported")
    rows = []
    for key, name, source, replaces in (
            ("K1", "warp_planes", "tecogan_tpu_torch/csrc/warp_planes.cu",
             "tecogan_tpu/ops/warp_pallas.py:153"),
            ("K1 band", "warp_planes_band",
             "tecogan_tpu_torch/csrc/warp_planes.cu",
             "tecogan_tpu/ops/warp_pallas.py:153"),
            ("K1 window", "warp_planes_window",
             "tecogan_tpu_torch/csrc/warp_planes.cu",
             "tecogan_tpu/ops/warp_pallas.py:153, "
             "tecogan_tpu/ops/warp.py:72"),
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
             "tecogan_tpu/ops/warp_pallas.py:324"),
            ("K1 zero", "warp_zero", "tecogan_tpu_torch/csrc/warp_planes.cu",
             "none (BasicVSR++'s flow_warp)"),
            ("DCN", "dcn_columns", "tecogan_tpu_torch/csrc/dcn.cu",
             "none (mmcv's modulated_deform_conv2d)")):
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
