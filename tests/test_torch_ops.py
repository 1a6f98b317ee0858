"""Port parity: resampling matrices, space<->depth, BD degradation and
quantisation of tecogan_tpu_torch against the JAX package (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tecogan_tpu import ops as jops
from tecogan_tpu.ops import resize as jresize
from tecogan_tpu_torch import ops as tops
from tecogan_tpu_torch.ops import resize as tresize


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode,size,kw", [
    ("bilinear_half_pixel", 7, dict(scale=2)),
    ("bilinear_half_pixel", 33, dict(scale=4)),
    ("bilinear_fractional", 13, dict(out_size=29)),
    ("tecogan_bicubic", 1, dict(scale=4)),
    ("tecogan_bicubic", 48, dict(scale=4)),
    ("tecogan_bicubic", 17, dict(scale=2)),
    ("gauss_down", 64, dict(scale=4, sigma=1.5, pad=True)),
    ("gauss_down", 75, dict(scale=4, sigma=1.5, pad=False)),
    ("gauss_down", 30, dict(scale=2, sigma=0.8, pad=True)),
    ("matlab_bicubic", 40, dict(out_size=10)),
    ("matlab_bicubic", 9, dict(out_size=36)),
])
def test_resize_matrix_equal(mode, size, kw):
    np.testing.assert_array_equal(tresize.resize_matrix(mode, size, **kw),
                                  jresize.resize_matrix(mode, size, **kw))


@pytest.mark.parametrize("fn", ["upsample_bilinear",
                                "upsample_tecogan_bicubic"])
@pytest.mark.parametrize("scale", [2, 4])
def test_upsample_matches_jax(rng, fn, scale):
    x = rng.random((2, 9, 13, 3)).astype(np.float32)
    want = np.asarray(getattr(jops, fn)(jnp.asarray(x), scale))
    got = _nhwc(getattr(tops, fn)(_nchw(x), scale))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("mode", ["bilinear_half_pixel", "tecogan_bicubic"])
@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_upsample_nhwc_matches_nchw(rng, mode, scale, dtype):
    """The separable upsample on a channels_last tensor's NHWC memory
    (FNet's bf16 route) against the NCHW form on the same values."""
    x = torch.from_numpy(rng.random((2, 5, 9, 13)).astype(np.float32)).to(
        dtype)
    want = tresize.get_upsampling_fn(
        scale, "BI" if mode == "bilinear_half_pixel" else "BD")(x)
    got = tresize.upsample_nhwc(
        x.contiguous(memory_format=torch.channels_last), mode, scale)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=1e-5)


def test_get_upsampling_fn():
    x = torch.rand(1, 3, 5, 6)
    for deg, fn in (("BD", tops.upsample_tecogan_bicubic),
                    ("BI", tops.upsample_bilinear)):
        torch.testing.assert_close(tops.get_upsampling_fn(4, deg)(x),
                                   fn(x, 4), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.get_upsampling_fn(4, "XX")


@pytest.mark.parametrize("scale", [2, 4])
def test_space_to_depth_matches_jax(rng, scale):
    x = rng.standard_normal((2, 4 * scale, 3 * scale, 3)).astype(np.float32)
    want = np.asarray(jops.space_to_depth(jnp.asarray(x), scale))
    got = tops.space_to_depth(_nchw(x), scale)
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-6)
    back = tops.depth_to_space(got, scale)
    np.testing.assert_allclose(_nhwc(back), x, atol=1e-6)
    want_d2s = np.asarray(jops.depth_to_space(jnp.asarray(want), scale))
    np.testing.assert_allclose(_nhwc(back), want_d2s, atol=1e-6)


def test_space_to_depth_is_not_pixel_unshuffle(rng):
    """The reference channel order differs from F.pixel_unshuffle's."""
    x = torch.from_numpy(rng.standard_normal((1, 3, 8, 8)).astype(np.float32))
    ours = tops.space_to_depth(x, 4)
    theirs = torch.nn.functional.pixel_unshuffle(x, 4)
    assert not torch.equal(ours, theirs)
    # channel (dy*s+dx)*c + ch holds x[ch, dy::s, dx::s]
    torch.testing.assert_close(ours[:, (1 * 4 + 2) * 3 + 1], x[:, 1, 1::4, 2::4])


@pytest.mark.parametrize("pad_data", [True, False])
@pytest.mark.parametrize("shape", [(2, 64, 48, 3), (1, 37, 53, 3)])
def test_downsample_bd_matches_jax(rng, shape, pad_data):
    x = rng.random(shape).astype(np.float32)
    want = np.asarray(jops.downsample_bd(jnp.asarray(x), 4, sigma=1.5,
                                         pad_data=pad_data))
    got = _nhwc(tops.downsample_bd(_nchw(x), 4, sigma=1.5, pad_data=pad_data))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_bd_border_size():
    for sigma in (0.5, 1.5, 2.2):
        assert tops.bd_border_size(sigma) == jops.bd_border_size(sigma)


def test_quantize_uint8_matches_jax(rng):
    x = np.concatenate([
        rng.random(1000).astype(np.float32) * 1.4 - 0.2,
        # exact halves: round-half-even must agree
        (np.arange(0, 256, dtype=np.float32) + 0.5) / 255.0,
    ])
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) * 255.0), 0, 255)
                      .astype(jnp.uint8))
    got = tops.quantize_uint8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    got16 = tops.quantize_uint8(torch.from_numpy(x).bfloat16()).numpy()
    want16 = np.asarray(jnp.clip(jnp.round(
        jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32) * 255.0),
        0, 255).astype(jnp.uint8))
    np.testing.assert_array_equal(got16, want16)


@pytest.mark.parametrize("shape,kw", [
    ((2, 48, 56, 3), dict(scale=0.25)),
    ((37, 53, 3), dict(scale=0.25)),
    ((1, 20, 28, 3), dict(scale=0.5, antialias=False)),
    ((9, 13, 3), dict(scale=4)),
    ((2, 40, 30, 3), dict(out_shape=(13, 7))),
])
def test_imresize_matlab_matches_jax(rng, shape, kw):
    x = rng.random(shape)
    want = jops.imresize_matlab(x, **kw)
    got = tops.imresize_matlab(x, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # a torch tensor takes the same matrices on its device, in its dtype
    t = tops.imresize_matlab(torch.from_numpy(x.astype(np.float32)), **kw)
    assert t.dtype == torch.float32 and tuple(t.shape) == want.shape
    np.testing.assert_allclose(t.numpy(), want, atol=1e-5)
