"""The GAN D phase's fp32 band (``chip_smoke.py::phase_gan_card_vs_cpu``)
on the D inputs that fail it on the card, rebuilt on the CPU by
``d_band.py``: what the CPU's float32, its BatchNorm backward and the JAX
package keep there, and how far those inputs amplify a convolution's
rounding.

The band holds the card's fp32 D gradients within max(1e-3, 4x the CPU
fp32's) of float64. On these inputs the card reads 4.91e-3 at
``discriminator_block.block1.1.bias``, the CPU 2.35e-6. BatchNorm is not
where the bits go: PyTorch's CPU BatchNorm backward adds float32 terms in
float64 only as its threads split a channel, and BatchNorm as plain
float32 ops keeps the bits, as does the JAX package's fp32 D (its own
``nn.batch_norm``, XLA's float32 reductions). A convolution's rounding is
amplified: TF32-level rounding of the operands of conv_in or of one of
blocks 1-3 moves that gradient by 3-8e-2, of block 4 by 5e-4.
``python3 d_band.py`` on the card
names the pass: block 1's forward under cuDNN (64 to 64 channels, 4x4,
stride 2), with TF32 off and with cuDNN's deterministic algorithms alike;
with that forward alone in float64, or with cuDNN off (PyTorch's native
convolution), the card reads 1.4-1.8e-6. Its rounding puts one LeakyReLU
input of block 1, 2.9e-6 from the kink in float64, on the other side
(``tests/test_torch_conv_f32.py``).
"""

import importlib.util
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tecogan_tpu.models.losses import vanilla_gan_loss
from tecogan_tpu.models.networks.discriminators import trunk_apply
from tecogan_tpu_torch.models import convert
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# fp32 with float32 products keeps D's gradients this close to float64 on
# the failing inputs; the card's 4.91e-3 is 160 times this
FP32_REL = 3e-5


@pytest.fixture(scope="module")
def d_band():
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location(
        "d_band", osp.join(REPO, "d_band.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def failing(d_band):
    """(D's state dict, its real and fake input, the float64 gradients)."""
    sd, xr, xf = d_band.d_inputs()
    return sd, xr, xf, d_band.d_grads(sd, xr, xf, "cpu", torch.float64)


def _rel(got, ref):
    return {k: float((got[k] - v).norm() / v.norm()) for k, v in ref.items()}


@pytest.mark.parametrize("threads, want", [(1, 0.0), (8, 1.0)])
def test_cpu_batch_norm_bias_gradient_on_a_cancelling_channel(threads,
                                                              want):
    """On a channel whose output gradient is [1e8, 1, -1e8] over the
    batch, the float32 sum in that order is 0.0 and the float64 sum 1.0.
    ``F.batch_norm``'s CPU backward gives the float32 sum at one thread and
    the float64 one at eight, where each batch entry is a thread's partial
    sum and the partials are added in float64: the CPU fp32 yardstick of
    phase 13's band is float64 in BatchNorm only as the threads split it."""
    g = torch.tensor([1e8, 1.0, -1e8]).reshape(3, 1, 1, 1)
    x = torch.tensor([0.0, 1.0, 2.0]).reshape(3, 1, 1, 1)
    acc = np.float32(0)
    for v in g.flatten().numpy():
        acc = np.float32(acc + v)
    assert float(acc) == 0.0 and float(g.double().sum()) == 1.0
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        w = torch.ones(1, requires_grad=True)
        b = torch.zeros(1, requires_grad=True)
        F.batch_norm(x, None, None, w, b, training=True).backward(g)
    finally:
        torch.set_num_threads(n)
    assert float(b.grad) == want


def test_failing_inputs_keep_their_bits_in_fp32(d_band, failing):
    """On the inputs phase 13 fails on the card (chip_smoke's rng after
    phases 8, 10, 11, 12), the CPU's fp32 D gradients are within FP32_REL
    of float64 everywhere, with ``F.batch_norm`` (float64 accumulators)
    and with every BatchNorm as plain float32 ops alike: BatchNorm's
    float32 sums do not lose the bits the card loses."""
    sd, xr, xf, ref = failing
    assert tuple(xr.shape) == tuple(xf.shape) == (2, 27, 64, 64)
    for plain in (False, True):
        err = _rel(d_band.d_grads(sd, xr, xf, "cpu", plain_bn=plain), ref)
        assert max(err.values()) <= FP32_REL, (plain, err)
        assert err[d_band.TAG] > 0


def test_jax_fp32_keeps_the_bits_on_the_failing_inputs(failing):
    """The JAX package's fp32 D (``trunk_apply``, the same weights through
    ``convert.jax_from_d_state_dict``, its own BatchNorm) on the same
    inputs: every gradient within FP32_REL of float64."""
    sd, xr, xf, ref = failing
    params = jax.tree.map(jnp.asarray,
                          convert.jax_from_d_state_dict(sd, 64))
    xr_j, xf_j = (jnp.asarray(x.detach().permute(0, 2, 3, 1).numpy())
                  for x in (xr, xf))

    def loss(p):
        real, _, _ = trunk_apply(p, xr_j, train=True)
        fake, _, _ = trunk_apply(p, xf_j, train=True)
        return vanilla_gan_loss(real, True) + vanilla_gan_loss(fake, False)

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params))
    got = convert.d_state_dict_from_jax(grads, 64)
    err = _rel({k: torch.as_tensor(np.asarray(got[k]), dtype=torch.float64)
                for k in ref}, ref)
    assert max(err.values()) <= FP32_REL, err


@pytest.mark.parametrize("layer, lo, hi", [
    ("conv_in", 1e-2, 1.0), ("block1", 1e-2, 1.0), ("block2", 1e-2, 1.0),
    ("block3", 1e-2, 1.0), ("block4", 1e-4, 1e-2)])
def test_failing_inputs_amplify_convolution_rounding(d_band, failing, layer,
                                                     lo, hi):
    """One convolution's operands rounded to TF32 (forward and backward),
    the rest fp32: D's first BatchNorm bias gradient moves by [lo, hi]
    relative; the layers nearest the input move it most. The card's 4.91e-3
    sits between fp32 and TF32."""
    sd, xr, xf, ref = failing
    name = ("conv_in.0" if layer == "conv_in"
            else f"discriminator_block.{layer}.0")
    assert name in d_band.CONVS
    err = _rel(d_band.d_grads(sd, xr, xf, "cpu", tf32=name), ref)
    assert lo <= err[d_band.TAG] <= hi, err[d_band.TAG]
