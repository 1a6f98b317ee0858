"""Where the GAN D phase's fp32 gradients lose their bits on the D inputs
that fail ``chip_smoke.py``'s band (``phase_gan_card_vs_cpu``: the card's
fp32 D gradients against float64, at most max(1e-3, 4x the CPU fp32's)).

    python3 d_band.py          # needs a card
    python3 d_band.py --cpu    # the CPU's side alone

The inputs are rebuilt on the CPU from ``chip_smoke.SEED``, drawing the
random numbers that ``chip_smoke.py``'s phases 8, 10, 11 and 12 draw, in
their order, before phase 13's batch; phase 13's CPU step then records
D's real and fake inputs (2 x 27 x 64 x 64 each). The reference is D's
phase in float64 on the CPU; each line gives the relative L2 distance of
every gradient tensor from it (the largest, and D's first BatchNorm bias,
``discriminator_block.block1.1.bias``, where the band failed).

On the CPU: fp32 as it runs there (``F.batch_norm``, whose CPU backward
sums in float64), with every BatchNorm as plain float32 ops (its
backward's sums in float32), and with the operands of one convolution
rounded to TF32 (10-bit mantissa) in its forward and backward, to show
how far this input amplifies a convolution's rounding. On the card: fp32
with TF32 off (phase 13's setting), with cuDNN's deterministic
algorithms, with cuDNN off (PyTorch's native convolutions), and with one
layer at a time in float64 (its input and weights cast, so its forward
and backward run in float64), which names the layer that loses the bits.
Prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess

import numpy as np
import torch

import chip_smoke as cs

TAG = "discriminator_block.block1.1.bias"
# conv layers by (out, in) channels of their weight
LAYERS = {"conv_in": (64, 27), "block1": (64, 64), "block2": (128, 64),
          "block3": (256, 128), "block4": (256, 256)}


def d_inputs():
    """(D's state dict, its real and fake input) of phase 13's CPU step
    after phases 8, 10, 11 and 12 drew from ``SEED``'s generator."""
    from tecogan_tpu_torch.models.convert import state_dict_from_jax
    from tecogan_tpu_torch.models.networks import VGG19, DTrunk, STNetConfig

    rng = np.random.default_rng(cs.SEED)
    sd = state_dict_from_jax(cs._jax_layout_params(rng, cs.NF, cs.NB,
                                                   cs.SCALE), cs.NB, cs.SCALE)
    cs._smooth_frames(rng, 8, 64, 64)  # phase 8
    for _ in range(cs.TRAIN_STEPS):  # phase 10
        cs._gt_clips(rng, cs.TRAIN_BATCH, cs.TRAIN_T, 128 + 2 * int(1.5 * 3))
    cs._gt_clips(rng, 2, 3, 16 * cs.SCALE + 2 * int(1.5 * 3))  # phase 11
    cs._jax_layout_params(rng, cs.NF, cs.NB, cs.SCALE)  # phase 12
    opt = cs._gan_opt("", "")
    n = opt["dataset"]["train"]["batch_size_per_gpu"]
    size = opt["dataset"]["train"]["crop_size"] + 2 * int(1.5 * 3)
    for _ in range(cs.GAN_STEPS):
        cs._gt_clips(rng, n, opt["train"]["tempo_extent"], size)
    sds = {"g": sd,
           "d": DTrunk.random(STNetConfig(spatial_size=cs.GAN_CMP_HR),
                              torch.Generator().manual_seed(cs.SEED + 1))
           .state_dict(),
           "vgg": VGG19.random(torch.Generator().manual_seed(cs.SEED + 2))
           .state_dict()}
    batch = cs._gt_clips(rng, 2, cs.GAN_CMP_TE,
                         cs.GAN_CMP_HR + 2 * int(1.5 * 3))
    seen = []
    cs._one_gan_step(sds, batch, "cpu", mixed=False, d_inputs=seen)
    return sds["d"], seen[0], seen[1]


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


def _tf32_mode(shape):
    """A dispatch mode rounding the operands of the convolution whose
    weight has ``shape`` (out, in) to TF32, forward and backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            w = {"convolution": 1, "convolution_backward": 2}.get(name)
            if w is not None and tuple(args[w].shape[:2]) == shape:
                k = w + 1
                args = (*map(_tf32, args[:k]), *args[k:])
            return func(*args, **(kwargs or {}))

    return Mode()


def d_grads(sd, x_real, x_fake, device, dtype=torch.float32, f64=None,
            plain_bn=False, mode=None):
    """D's phase (its loss on the real, then the fake input) on ``device``
    in ``dtype``: {name: float64 CPU gradient}. ``f64`` names a layer
    (``LAYERS``, "bn" for every BatchNorm, "dense") computed in float64."""
    from tecogan_tpu_torch.models.losses import define_criterion
    from tecogan_tpu_torch.models.networks import DTrunk, STNetConfig
    from tecogan_tpu_torch.models.networks import discriminators as disc

    net = DTrunk.from_state_dict(STNetConfig(spatial_size=cs.GAN_CMP_HR), sd,
                                 device).to(dtype)
    hooks = []

    def in_f64(module, args):
        return tuple(a.double() for a in args)

    def back(module, args, out):
        return out.to(dtype)

    for name, m in net.named_modules():
        wide = (isinstance(m, torch.nn.Conv2d) and f64 in LAYERS
                and tuple(m.weight.shape[:2]) == LAYERS[f64]) or (
            f64 == "bn" and isinstance(m, disc.BatchNorm2d)) or (
            f64 == "dense" and name == "dense")
        if wide:
            m.double()
            hooks += [m.register_forward_pre_hook(in_f64),
                      m.register_forward_hook(back)]
    crit = define_criterion(cs._gan_cmp_config(False).gan_crit)
    bn = disc.batch_norm
    if plain_bn:
        disc.batch_norm = plain_batch_norm
    try:
        with mode or contextlib.nullcontext():
            real, _ = net(x_real.to(device, dtype))
            fake, _ = net(x_fake.to(device, dtype))
            (crit(real, True) + crit(fake, False)).backward()
    finally:
        disc.batch_norm = bn
        for h in hooks:
            h.remove()
    return {k: p.grad.double().cpu() for k, p in net.named_parameters()}


def report(label, got, ref):
    err = {k: float((got[k] - v).norm() / v.norm()) for k, v in ref.items()}
    worst = max(err, key=err.get)
    print(f"{label:58s} max {err[worst]:.3g} ({worst}); {TAG} {err[TAG]:.3g}",
          flush=True)
    return err


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        print("no CUDA device (python3 d_band.py --cpu runs the CPU side)")
        return 2
    sd, xr, xf = d_inputs()
    print(f"D inputs {tuple(xr.shape)} x2 ({xr.dtype}), from chip_smoke.SEED "
          f"{cs.SEED} after phases 8, 10, 11, 12")
    ref = d_grads(sd, xr, xf, "cpu", torch.float64)
    if a.cpu:
        report("CPU fp32 (F.batch_norm)", d_grads(sd, xr, xf, "cpu"), ref)
        report("CPU fp32, BatchNorm as plain float32 ops",
               d_grads(sd, xr, xf, "cpu", plain_bn=True), ref)
        for name, shape in LAYERS.items():
            report(f"CPU fp32, {name}'s operands rounded to TF32",
                   d_grads(sd, xr, xf, "cpu", mode=_tf32_mode(shape)), ref)
        return 0
    from tecogan_tpu_torch.nn import no_tf32

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}, torch {torch.__version__}, cuDNN "
          f"{torch.backends.cudnn.version()}")
    with no_tf32():
        report("card fp32, TF32 off (phase 13)",
               d_grads(sd, xr, xf, "cuda"), ref)
        report("card fp32, TF32 off, again", d_grads(sd, xr, xf, "cuda"), ref)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            report("card fp32, cuDNN deterministic algorithms",
                   d_grads(sd, xr, xf, "cuda"), ref)
        with torch.backends.cudnn.flags(enabled=False):
            report("card fp32, cuDNN off (native convolutions)",
                   d_grads(sd, xr, xf, "cuda"), ref)
        report("card fp32, BatchNorm as plain float32 ops",
               d_grads(sd, xr, xf, "cuda", plain_bn=True), ref)
        for layer in (*LAYERS, "bn", "dense"):
            report(f"card fp32, {layer} in float64",
                   d_grads(sd, xr, xf, "cuda", f64=layer), ref)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
