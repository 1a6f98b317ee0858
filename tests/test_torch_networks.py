"""Port parity for the generator: weight bridge, FNet, SRNet and the
single-frame step of tecogan_tpu_torch against the JAX package (CPU),
on the same weights and inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu.models import convert as jconvert
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import fnet_apply, init_frnet, srnet_apply
from tecogan_tpu.models.networks import step as jstep
from tecogan_tpu.ops import space_to_depth as jspace_to_depth
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch.models.convert import state_dict_from_jax
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               define_generator)
from tecogan_tpu_torch.utils import ckpt as tckpt

_NF, _NB = 16, 2


def _np_tree(tree):
    return jax.tree.map(np.array, tree)  # writable copies


@pytest.fixture(scope="module", params=[4, 2])
def nets(request):
    scale = request.param
    jcfg = JCfg(nf=_NF, nb=_NB, scale=scale, degradation="BD",
                pallas_warp=False)
    params = _np_tree(init_frnet(jax.random.PRNGKey(5), jcfg))
    cfg = FRNetConfig(nf=_NF, nb=_NB, scale=scale)
    net = FRNet.from_state_dict(cfg, state_dict_from_jax(params, _NB, scale))
    return jcfg, params, cfg, net


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_state_dict_matches_export_frnet(nets):
    jcfg, params, _, net = nets
    want = jconvert.export_frnet(params, _NB, jcfg.scale)
    got = state_dict_from_jax(params, _NB, jcfg.scale)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0,
                                   msg=lambda m: f"{k}: {m}")
    # the module's own names are the reference's
    assert set(net.state_dict()) == set(want)


def test_fnet_matches_jax(rng, nets):
    _, params, _, net = nets
    cur = rng.random((2, 20, 28, 3)).astype(np.float32)
    prev = rng.random((2, 20, 28, 3)).astype(np.float32)
    want = np.asarray(fnet_apply(params["fnet"], jnp.asarray(cur),
                                 jnp.asarray(prev)))
    assert want.shape == (2, 16, 24, 2)
    with torch.no_grad():
        got = _nhwc(net.fnet(_nchw(cur), _nchw(prev)))
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("packed_tail", [True, False])
def test_srnet_matches_jax(rng, nets, packed_tail):
    jcfg, params, _, net = nets
    s = jcfg.scale
    lr = rng.random((2, 12, 10, 3)).astype(np.float32)
    hr = rng.random((2, 12 * s, 10 * s, 3)).astype(np.float32)
    want = np.asarray(srnet_apply(
        params["srnet"], jnp.asarray(lr), jspace_to_depth(jnp.asarray(hr), s),
        _NB, s, "BD", packed_tail=packed_tail))
    with torch.no_grad():
        got = _nhwc(net.srnet(_nchw(lr), _nchw(hr)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_step_matches_jax(rng, nets):
    jcfg, params, _, net = nets
    s = jcfg.scale
    cur = rng.random((1, 20, 28, 3)).astype(np.float32)
    prev = rng.random((1, 20, 28, 3)).astype(np.float32)
    hr = rng.random((1, 20 * s, 28 * s, 3)).astype(np.float32)
    want = np.asarray(jstep(params, jnp.asarray(cur), jnp.asarray(prev),
                            jnp.asarray(hr), jcfg))
    with torch.no_grad():
        got = _nhwc(net.step(_nchw(cur), _nchw(prev), _nchw(hr)))
    np.testing.assert_allclose(got, want, atol=1e-4)


def _opt(**gen):
    g = {"name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": _NF, "nb": _NB}
    g.update(gen)
    return {"scale": 4, "dataset": {"degradation": {"type": "BD"}},
            "model": {"generator": g}}


def test_define_generator():
    cfg, build = define_generator(_opt(compute_dtype="bfloat16"))
    assert cfg == FRNetConfig(nf=_NF, nb=_NB, scale=4, degradation="BD",
                              compute_dtype="bfloat16")
    a = build(torch.Generator().manual_seed(3))
    b = build(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # torch-default bounds: U(+-1/sqrt(fan_in))
    w = a.srnet.conv_in[0].weight
    assert w.abs().max() <= 1 / np.sqrt(w.shape[1] * 9)
    with pytest.raises(ValueError, match="compute_dtype"):
        define_generator(_opt(compute_dtype="float16"))
    with pytest.raises(ValueError, match="generator"):
        define_generator(_opt(name="EDVR"))


def test_from_state_dict_rejects_mismatch(nets):
    _, params, cfg, _ = nets
    sd = state_dict_from_jax(params, _NB, cfg.scale)
    del sd["srnet.conv_out.bias"]
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        FRNet.from_state_dict(cfg, sd)
    deeper = FRNetConfig(nf=_NF, nb=_NB + 1, scale=cfg.scale)
    with pytest.raises(RuntimeError):
        FRNet.from_state_dict(deeper, state_dict_from_jax(params, _NB,
                                                          cfg.scale))


def test_ckpt_npz_and_pth_load_the_same_weights(tmp_path, nets):
    _, params, cfg, net = nets
    npz = str(tmp_path / "G.npz")
    pth = str(tmp_path / "G.pth")
    jckpt.save_pytree(params, npz)
    torch.save(jconvert.export_frnet(params, _NB, cfg.scale), pth)

    tree = tckpt.load_pytree(npz)
    want = jckpt.load_pytree(npz)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)

    ref = net.state_dict()
    for path in (npz, pth):
        sd = tckpt.load_generator_params(path, _NB, cfg.scale)
        assert set(sd) == set(ref)
        for k in ref:
            torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
