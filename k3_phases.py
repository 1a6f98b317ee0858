"""Where the device time of K3 (the image adjoint of the training warp,
tecogan_tpu_torch/csrc/warp_vjp.cu) goes, on one NVIDIA GPU.

    python3 k3_phases.py

Builds warp_vjp.cu as it is and as variants with one part taken out (a
text substitution in the source each), and times every build's K3 at the
training warps' shapes, bf16, on an i.i.d. flow (chip_smoke.py's timing
flow), a smooth one (as FNet's upsampled flows are) and a zero flow:

- kernel: the source as it is, held bit for bit against its plain version;
- no merge: every term its own atomic (no lane takes its left
  neighbour's term for a shared tap);
- fp32 atomics: the non-finite branch's fp32 atomics for every call (other
  bits, the same traffic);
- no scatter: the launch, both grid barriers, the zero fill, the max and
  the convert;
- no scatter, no barriers: the launch, the fill, the max and the convert
  (a race, timed only).

Device microseconds a call from torch.profiler (each kernel's mean per
launch), with the card's name and power limit. Exits 2 without CUDA.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "k3_phases"
_NO_SCATTER = ("if (mine) scatter(px, blockIdx.z, i1, j1, 0);",
               "if (mine && H < 0) scatter(px, blockIdx.z, i1, j1, 0);")
# (label, [(text, replacement), ...]) applied to warp_vjp.cu
VARIANTS = (
    ("kernel", []),
    ("no merge", [("take[r] = live && threadIdx.x > 0 && right == o[2 * r];",
                   "take[r] = false;")]),
    ("fp32 atomics", [("const bool fixed = m < 0x7f800000u;",
                       "const bool fixed = false;")]),
    ("no scatter", [_NO_SCATTER]),
    ("no scatter, no barriers", [_NO_SCATTER, ("grid.sync();", ";")]),
)
SHAPES = ((2, 3, 128, 128), (18, 3, 32, 32))


def build(kernel_build) -> dict:
    """Compile every variant (one nvcc each, all at once); return
    {label: ctypes library}."""
    src = (kernel_build.CSRC_DIR / "warp_vjp.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, (label, subs) in enumerate(VARIANTS):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{label}: {old!r} is not in warp_vjp.cu")
            text = text.replace(old, new)
        cu, so = OUT / f"v{k}.cu", OUT / f"v{k}.so"
        cu.write_text(text)
        procs[label] = (so, subprocess.Popen(
            [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-I",
             str(kernel_build.CSRC_DIR), "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _card_line, _device_ms, _smooth_flow
    from tecogan_tpu_torch import kernel_build
    from tecogan_tpu_torch.ops.warp_cuda import _DTYPE_TAG
    from tecogan_tpu_torch.ops.warp_vjp import (_dimage_slots,
                                                warp_dimage_reference)

    card = _card_line()
    libs = build(kernel_build)
    dev = torch.device("cuda", 0)
    slots = _dimage_slots(0)
    buf = (ctypes.c_int64 * 32)()

    def call(lib, g, flow):
        name = (f"tecogan_warp_dimage_{_DTYPE_TAG[g.dtype]}_"
                f"{_DTYPE_TAG[flow.dtype]}_{_DTYPE_TAG[g.dtype]}")
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = (ctypes.c_void_p,), ctypes.c_int
        out = torch.empty_like(g)
        scratch = torch.empty(out.numel() + slots, dtype=torch.int64,
                              device=dev)
        args = [g.data_ptr(), flow.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), *g.shape, slots, *g.stride(),
                *out.stride(), *flow.stride(),
                torch.cuda.current_stream().cuda_stream]
        buf[:len(args)] = args
        err = fn(ctypes.addressof(buf))
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        return out

    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"K3 device us/call by variant (torch.profiler), bf16 g and flow, "
          f"on {card}")
    for shape in SHAPES:
        n, _, h, w = shape
        g = torch.randn(shape, generator=gen, device=dev).bfloat16()
        flows = {
            "i.i.d. sigma 6": torch.randn((n, h, w, 2), generator=gen,
                                          device=dev) * 6.0,
            "smooth sigma 6": _smooth_flow(gen, dev, n, h, w, 6.0).permute(
                0, 2, 3, 1),
            "zero": torch.zeros((n, h, w, 2), device=dev)}
        for label, flow in flows.items():
            flow = flow.bfloat16().contiguous()
            got = call(libs["kernel"], g, flow)
            torch.cuda.synchronize()
            if not torch.equal(got,
                               warp_dimage_reference(g, flow, torch.bfloat16)):
                raise RuntimeError(f"K3 differs from its plain version at "
                                   f"{shape} {label}")
            times = {v: _device_ms(lambda: call(lib, g, flow), iters=50)
                     for v, lib in libs.items()}
            print(f"{shape} {label}: " + ", ".join(
                f"{v} {'not measured' if t is None else f'{t * 1e3:.2f}'}"
                for v, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
