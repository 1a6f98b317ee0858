"""Where the GAN D phase's fp32 gradients lose their bits on the D inputs
that once failed ``chip_smoke.py``'s band (``phase_gan_card_vs_cpu``: the
card's fp32 D gradients against float64, at most max(1e-3, 4x the CPU
fp32's)).

    python3 d_band.py                          # needs a card
    python3 d_band.py --cpu                    # the CPU's side alone
    python3 d_band.py --api_log build/cudnn_api.log

The inputs are rebuilt on the CPU by ``chip_smoke._d_band_case``: the
random numbers that ``chip_smoke.py``'s phases 8, 10, 11 and 12 draw from
``chip_smoke.SEED``, in their order, before phase 13's batch; phase 13's
CPU step then records D's real and fake inputs (2 x 27 x 64 x 64 each).
The reference is D's phase in float64 on the CPU; each line gives the
relative L2 distance of every gradient tensor from it (the largest, and
D's first BatchNorm bias, ``discriminator_block.block1.1.bias``, where the
band failed).

On the CPU: fp32 as it runs there (``F.batch_norm``, whose CPU backward
sums in float64), with every BatchNorm as plain float32 ops (its
backward's sums in float32), and with one convolution's operands rounded
to TF32 (10-bit mantissa) in its forward and backward, to show how far
this input amplifies a convolution's rounding. On the card, first the
TF32 settings that ``nn.no_tf32`` leaves (the legacy ``allow_tf32`` flags
and torch's ``fp32_precision`` settings beside them), then D's phase in
fp32: under an fp32 step's own settings (``nn.training_numerics``: D's
forwards from float64), with TF32 off (``nn.no_tf32``: every pass under
cuDNN, as phase 13 once ran it), with cuDNN's deterministic algorithms,
with cuDNN off (PyTorch's native convolutions), with one layer at a time
in float64 (its input and weights cast, so its forward and backward run
in float64), and with one pass of one convolution at a time in float64
(its forward, its input gradient or its weight gradient; the other two
passes in fp32 as they run), which names the pass that loses the bits.
Then each pass of each convolution alone on its own operands (from the
CPU's fp32 run) against float64, with the CUDA kernels it launched; with
``--api_log``, the same passes again in a child process under cuDNN's API
log (``CUDNN_LOGLEVEL_DBG=3``), split by pass into that file, with the
engine of each pass printed. Prints the card's name and power limit, the
inputs' sha256 and the host CPU that made them: the inputs are the same
bits only where that CPU rounds the same way.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs

TAG = "discriminator_block.block1.1.bias"
# D's convolutions by name, one layer each
CONVS = ("conv_in.0", *(f"discriminator_block.block{i}.0"
                        for i in range(1, 5)))
PASSES = ("forward", "dgrad", "wgrad")


def d_inputs():
    """(D's state dict, its real and fake input) of phase 13's CPU step
    after phases 8, 10, 11 and 12 drew from ``SEED``'s generator."""
    import numpy as np

    from tecogan_tpu_torch.models.convert import state_dict_from_jax

    rng = np.random.default_rng(cs.SEED)
    sd = state_dict_from_jax(cs._jax_layout_params(rng, cs.NF, cs.NB,
                                                   cs.SCALE), cs.NB, cs.SCALE)
    sds, _, seen = cs._d_band_case(sd)
    return sds["d"], seen[0], seen[1]


def host():
    """The CPU the inputs were computed on: its model, torch's thread count
    and the vector ISA torch dispatches to."""
    model = "unknown CPU"
    try:
        with open("/proc/cpuinfo") as f:
            model = next(ln.split(":", 1)[1].strip() for ln in f
                         if ln.startswith("model name"))
    except (OSError, StopIteration):
        pass
    return (f"{model}, {torch.get_num_threads()} threads, "
            f"{torch.backends.cpu.get_cpu_capability()}")


def plain_batch_norm(x, running_mean, running_var, weight, bias, train,
                     momentum=0.1, eps=1e-5):
    """Training-mode BatchNorm as plain ops in x's dtype (the JAX
    package's formulation): autograd's backward sums in that dtype."""
    mean = x.mean((0, 2, 3))
    c = x - mean[:, None, None]
    var = c.square().mean((0, 2, 3))
    return (c * torch.rsqrt(var + eps)[:, None, None] * weight[:, None, None]
            + bias[:, None, None])


def _tf32(t):
    """A float32 tensor rounded to TF32 (10-bit mantissa, to nearest even)."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        return t
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _tf32_mode(weight):
    """A dispatch mode rounding the operands of the convolution whose
    weight is ``weight`` to TF32, forward and backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ptr = weight.untyped_storage().data_ptr()

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            w = {"convolution": 1, "convolution_backward": 2}.get(name)
            if w is not None and args[w].untyped_storage().data_ptr() == ptr:
                k = w + 1
                args = (*map(_tf32, args[:k]), *args[k:])
            return func(*args, **(kwargs or {}))

    return Mode()


def _pass_f64_mode(weight, kind):
    """A dispatch mode running one pass of the convolution whose weight is
    ``weight`` in float64 from its fp32 operands: its forward, its input
    gradient ("dgrad") or its weight gradient ("wgrad"), the result cast
    back; every other pass runs as it does. ``mode.hits`` counts the
    passes it replaced."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ptr = weight.untyped_storage().data_ptr()

    def wide(args):
        return [a.double() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]

    class Mode(TorchDispatchMode):
        hits = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if (name == "convolution" and kind == "forward"
                    and args[1].untyped_storage().data_ptr() == ptr):
                Mode.hits += 1
                return func(*wide(args)).to(out.dtype)
            i = {"dgrad": 0, "wgrad": 1}.get(kind)
            if (name == "convolution_backward" and i is not None
                    and args[10][i]
                    and args[2].untyped_storage().data_ptr() == ptr):
                Mode.hits += 1
                out = list(out)
                out[i] = func(*wide(args))[i].to(out[i].dtype)
                return tuple(out)
            return out

    return Mode()


def _net(sd, device, dtype=torch.float32):
    from tecogan_tpu_torch.models.networks import DTrunk, STNetConfig

    return DTrunk.from_state_dict(STNetConfig(spatial_size=cs.GAN_CMP_HR),
                                  sd, device).to(dtype)


def d_grads(sd, x_real, x_fake, device, dtype=torch.float32, f64=None,
            plain_bn=False, tf32=None, f64_pass=None, numerics=None):
    """D's phase (its loss on the real, then the fake input) on ``device``
    in ``dtype``: {name: float64 CPU gradient}. ``f64`` names a layer
    (one of ``CONVS``, "dense", or "bn" for every BatchNorm) computed in
    float64; ``tf32`` a convolution of ``CONVS`` whose operands are
    rounded to TF32 (``_tf32_mode``); ``f64_pass`` (a conv's name, a pass)
    one pass of one convolution (``_pass_f64_mode``); ``numerics`` a
    context manager entered around the phase."""
    from tecogan_tpu_torch.models.losses import define_criterion
    from tecogan_tpu_torch.models.networks import discriminators as disc

    net = _net(sd, device, dtype)
    hooks = []

    def in_f64(module, args):
        return tuple(a.double() for a in args)

    def back(module, args, out):
        return out.to(dtype)

    for name, m in net.named_modules():
        if name == f64 or (f64 == "bn" and isinstance(m, disc.BatchNorm2d)):
            m.double()
            hooks += [m.register_forward_pre_hook(in_f64),
                      m.register_forward_hook(back)]
    mode = None
    if f64_pass is not None:
        mode = _pass_f64_mode(net.get_submodule(f64_pass[0]).weight,
                              f64_pass[1])
    elif tf32 is not None:
        mode = _tf32_mode(net.get_submodule(tf32).weight)
    crit = define_criterion(cs._gan_cmp_config(False).gan_crit)
    bn = disc.batch_norm
    if plain_bn:
        disc.batch_norm = plain_batch_norm
    try:
        with numerics or contextlib.nullcontext(), \
                mode or contextlib.nullcontext():
            real, _ = net(x_real.to(device, dtype))
            fake, _ = net(x_fake.to(device, dtype))
            (crit(real, True) + crit(fake, False)).backward()
    finally:
        disc.batch_norm = bn
        for h in hooks:
            h.remove()
    if f64_pass is not None and not mode.hits:
        raise RuntimeError(f"{f64_pass}: no pass was replaced")
    return {k: p.grad.double().cpu() for k, p in net.named_parameters()}


def report(label, got, ref):
    err = {k: float((got[k] - v).norm() / v.norm()) for k, v in ref.items()}
    worst = max(err, key=err.get)
    print(f"{label:58s} max {err[worst]:.3g} ({worst}); {TAG} {err[TAG]:.3g}",
          flush=True)
    return err


def conv_operands(sd, x_real, x_fake):
    """{conv name: [(input, weight, output gradient) of each call]} of D's
    fp32 phase on the CPU, for running each pass alone."""
    from tecogan_tpu_torch.models.losses import define_criterion

    net = _net(sd, "cpu")
    got, hooks = {}, []
    for name in CONVS:
        m = net.get_submodule(name)

        def fwd(module, args, out, name=name):
            got.setdefault(name, []).append([args[0].detach().clone(),
                                             module.weight.detach().clone()])

        def bwd(module, g_in, g_out, name=name):
            # backward hooks fire in reverse order of the forwards
            calls = [c for c in got[name] if len(c) == 2]
            calls[-1].append(g_out[0].detach().clone())

        hooks += [m.register_forward_hook(fwd),
                  m.register_full_backward_hook(bwd)]
    crit = define_criterion(cs._gan_cmp_config(False).gan_crit)
    xr = x_real.clone().requires_grad_()
    xf = x_fake.clone().requires_grad_()
    (crit(net(xr)[0], True) + crit(net(xf)[0], False)).backward()
    for h in hooks:
        h.remove()
    return got


def run_pass(kind, x, w, g):
    """One pass of D's convolution (stride 1 for conv_in, else 4x4 stride
    2, padding 1, no bias) on the operands' device and dtype."""
    stride, pad = (1, 1) if w.shape[-1] == 3 else (2, 1)
    if kind == "forward":
        return F.conv2d(x, w, None, stride, pad)
    mask = [kind == "dgrad", kind == "wgrad", False]
    out = torch.ops.aten.convolution_backward(
        g, x, w, None, [stride] * 2, [pad] * 2, [1, 1], False, [0, 0], 1,
        mask)
    return out[0] if kind == "dgrad" else out[1]


def _kernels(fn):
    """The CUDA kernel names ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type.name == "CUDA"})


def isolated_passes(ops):
    """Each pass of each convolution alone on the card (fp32, TF32 off)
    on the operands of its first call: relative L2 from float64 beside the
    CPU fp32's, and its kernels."""
    from tecogan_tpu_torch.nn import no_tf32
    from tecogan_tpu_torch.tools.conv_audit import rel_l2

    with no_tf32():
        for name in CONVS:
            x, w, g = ops[name][0]
            for kind in PASSES:
                ref = run_pass(kind, x.double(), w.double(), g.double())
                cpu = rel_l2(run_pass(kind, x, w, g), ref)
                dev = [t.cuda() for t in (x, w, g)]
                card = rel_l2(run_pass(kind, *dev).cpu(), ref)
                names = _kernels(lambda: run_pass(kind, *dev))
                print(f"  {name} {kind}: card {card:.3g}, CPU fp32 "
                      f"{cpu:.3g}; kernels {names}", flush=True)


def _api_child(ops_path):
    """In a child under cuDNN's API log: each pass of each convolution,
    once, between markers on stderr (each pass's plan is built at its
    first call, so its engine is logged after its marker)."""
    from tecogan_tpu_torch.nn import no_tf32

    ops = torch.load(ops_path, weights_only=True)
    with no_tf32():
        for name in CONVS:
            x, w, g = (t.cuda() for t in ops[name][0])
            for kind in PASSES:
                print(f"=== d_band pass {name} {kind}", file=sys.stderr,
                      flush=True)
                run_pass(kind, x, w, g)
                torch.cuda.synchronize()
    print("=== d_band end", file=sys.stderr, flush=True)


ENGINE_RE = re.compile(
    r"function cudnnBackendExecuteInternal\(\) called:\n(.*?)\n\n", re.S)
KNOB_RE = re.compile(r"CUDNN_KNOB_TYPE_(\w+): type=int; val=(-?\d+)")


def api_log(ops, path):
    """The passes of ``_api_child`` under ``CUDNN_LOGLEVEL_DBG=3`` (to
    stderr), that log written to ``path``; prints each pass's engine
    lines."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ops_path = os.path.join(tmp, "ops.pt")
        torch.save({k: v[:1] for k, v in ops.items()}, ops_path)
        env = dict(os.environ, CUDNN_LOGLEVEL_DBG="3",
                   CUDNN_LOGDEST_DBG="stderr")
        res = subprocess.run([sys.executable, __file__, "--api_child",
                              ops_path], env=env, capture_output=True,
                             text=True)
    with open(path, "w") as f:
        f.write(res.stderr)
    print(f"cuDNN API log: {len(res.stderr)} bytes in {path} (child exit "
          f"{res.returncode})")
    parts = re.split(r"^=== d_band pass (\S+) (\S+)\n", res.stderr,
                     flags=re.MULTILINE)
    for i in range(1, len(parts) - 2, 3):
        for block in ENGINE_RE.findall(parts[i + 2]):
            field = dict(re.findall(r"^i!\s+(\w+): type=[^;]*; val=([^;]*);",
                                    block, re.M))
            knobs = KNOB_RE.findall(block)
            print(f"  {parts[i]} {parts[i + 1]}: {field.get('operation')} "
                  f"engine {field.get('engine_id')}, enable_tf32 "
                  f"{field.get('enable_tf32')}, knobs {knobs}")


def precision_settings():
    """The TF32 settings in force: the legacy flags and torch's
    ``fp32_precision`` ones."""
    c, m = torch.backends.cudnn, torch.backends.cuda.matmul
    conv = getattr(c, "conv", None)
    return (f"cudnn.allow_tf32 {c.allow_tf32}, cudnn.conv.fp32_precision "
            f"{getattr(conv, 'fp32_precision', 'absent')}, "
            f"cuda.matmul.allow_tf32 {m.allow_tf32}, "
            f"cuda.matmul.fp32_precision "
            f"{getattr(m, 'fp32_precision', 'absent')}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--api_log", help="write cuDNN's API log of each "
                    "convolution pass to this file")
    ap.add_argument("--api_child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.api_child:
        _api_child(a.api_child)
        return 0
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device (python3 d_band.py --cpu runs the CPU side)")
        return 2
    sd, xr, xf = d_inputs()
    print(f"D inputs {tuple(xr.shape)} x2 ({xr.dtype}), from chip_smoke.SEED "
          f"{cs.SEED} after phases 8, 10, 11, 12; sha256 "
          f"{cs._digest(xr, xf)[:16]} on {host()}")
    ref = d_grads(sd, xr, xf, "cpu", torch.float64)
    if a.cpu:
        report("CPU fp32 (F.batch_norm)", d_grads(sd, xr, xf, "cpu"), ref)
        report("CPU fp32, BatchNorm as plain float32 ops",
               d_grads(sd, xr, xf, "cpu", plain_bn=True), ref)
        for name in CONVS:
            report(f"CPU fp32, {name}'s operands in TF32",
                   d_grads(sd, xr, xf, "cpu", tf32=name), ref)
        return 0
    from tecogan_tpu_torch.nn import no_tf32, training_numerics

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}, torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    print(f"around: {precision_settings()}")
    with no_tf32():
        print(f"under nn.no_tf32: {precision_settings()}")
    with training_numerics(mixed_precision=False):
        print(f"under nn.training_numerics(False): {precision_settings()}")
    report("card fp32, an fp32 step's settings (forwards from float64)",
           d_grads(sd, xr, xf, "cuda",
                   numerics=training_numerics(mixed_precision=False)), ref)
    with no_tf32():
        report("card fp32, TF32 off (nn.no_tf32: cuDNN forwards)",
               d_grads(sd, xr, xf, "cuda"), ref)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            report("card fp32, cuDNN deterministic algorithms",
                   d_grads(sd, xr, xf, "cuda"), ref)
        with torch.backends.cudnn.flags(enabled=False):
            report("card fp32, cuDNN off (native convolutions)",
                   d_grads(sd, xr, xf, "cuda"), ref)
        report("card fp32, BatchNorm as plain float32 ops",
               d_grads(sd, xr, xf, "cuda", plain_bn=True), ref)
        for layer in (*CONVS, "bn", "dense"):
            report(f"card fp32, {layer} in float64",
                   d_grads(sd, xr, xf, "cuda", f64=layer), ref)
        for layer in CONVS:
            # D's phase takes no gradient of its input: conv_in has no dgrad
            for kind in PASSES[::2] if layer == CONVS[0] else PASSES:
                report(f"card fp32, {layer} {kind} alone in float64",
                       d_grads(sd, xr, xf, "cuda", f64_pass=(layer, kind)),
                       ref)
    ops = conv_operands(sd, xr, xf)
    print("each pass alone on its CPU fp32 operands (the first call):")
    isolated_passes(ops)
    if a.api_log:
        api_log(ops, a.api_log)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
