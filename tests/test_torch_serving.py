"""The port's serving programs (tecogan_tpu_torch.serving and
.tools.export_serving) on the CPU: export -> load bit for bit against the
port's live ``infer_sequence_batch``, within 1 gray level of the JAX
package's ``load_stream(export_stream(...))`` on the same weights, the
artifact file and its refusals, and the exporter's CLI. The serving host
(``serve``) is tested in tests/test_torch_serve.py."""

import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tecogan_tpu import serving as jserving
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch import serving
from tecogan_tpu_torch.models.convert import (jax_from_state_dict,
                                              state_dict_from_jax)
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
from tecogan_tpu_torch.tools import export_serving

N, T, H, W, CHUNK = 1, 5, 16, 24, 4


@pytest.fixture(scope="module")
def weights():
    """The JAX pytree (numpy leaves) and the port's state dict of it, drawn
    by the port (the JAX initialisers cost seconds of eager compiles)."""
    net = FRNet.random(_cfg(), torch.Generator().manual_seed(3))
    params = jax_from_state_dict(net.state_dict())
    return params, state_dict_from_jax(params)


@pytest.fixture(scope="module")
def lr():
    return np.random.default_rng(0).random((N, T, H, W, 3)).astype(
        np.float32)


def _cfg(dtype="float32", packed16=False):
    return FRNetConfig(nf=8, nb=2, scale=4, compute_dtype=dtype,
                       packed16=packed16)


@pytest.mark.parametrize("packed16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_load_matches_live_bit_for_bit(weights, lr, dtype, packed16):
    _, sd = weights
    cfg = _cfg(dtype, packed16)
    run = serving.load_stream(serving.export_stream(
        sd, cfg, N, T, H, W, chunk=CHUNK, platforms=["cpu"]))
    got = run(sd, lr)
    want = infer_sequence_batch(sd, torch.from_numpy(lr), cfg, chunk=CHUNK)
    assert got.dtype == torch.uint8 and got.shape == (N, T, 4 * H, 4 * W, 3)
    assert torch.equal(got, want)


def test_export_matches_jax_artifact_within_one_level(weights, lr):
    """The same weights through both packages' exported programs (fp32,
    the XLA gather warp on the JAX side): within 1 gray level, as the live
    paths are held (tests/test_torch_slice.py)."""
    params, sd = weights
    jcfg = JCfg(nf=8, nb=2, scale=4, pallas_warp=False)
    jrun = jserving.load_stream(jserving.export_stream(
        params, jcfg, N, T, H, W, chunk=CHUNK))
    want = np.asarray(jrun(params, jnp.asarray(lr)))
    got = serving.load_stream(serving.export_stream(
        sd, _cfg(), N, T, H, W, chunk=CHUNK, platforms=["cpu"]))(sd, lr)
    assert got.shape == want.shape
    assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1


@pytest.fixture(scope="module")
def blob(weights):
    return serving.export_stream(weights[1], _cfg(), N, T, H, W,
                                 chunk=CHUNK, platforms=["cpu"])


@pytest.mark.parametrize("embed", [True, False])
def test_artifact_file_round_trip(tmp_path, weights, lr, blob, embed):
    params, sd = weights
    path = str(tmp_path / "m.tecosrv")
    serving.save_artifact(path, blob, {"h": H, "w": W, "scale": 4},
                          params=sd if embed else None)
    run, meta, back = serving.load_artifact(path)
    assert meta == {"h": H, "w": W, "scale": 4}
    want = infer_sequence_batch(sd, torch.from_numpy(lr), _cfg(),
                                chunk=CHUNK)
    if not embed:
        assert back is None
        assert torch.equal(run(sd, lr), want)
        return
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    assert torch.equal(run(back, lr), want)
    # the JAX package's reader takes the embedded weights as they are
    with np.load(_npz_of(path)) as z:
        jtree = jckpt._unflatten({k[len("params/"):]: z[k] for k in z.files
                                  if k.startswith("params/")})
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def _npz_of(path):
    """The npz after an artifact's magic, as a file of its own."""
    with open(path, "rb") as f:
        data = f.read()[8:]
    out = path + ".npz"
    with open(out, "wb") as f:
        f.write(data)
    return out


def test_each_package_refuses_the_others_artifact(tmp_path, weights, blob):
    params, sd = weights
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="bad magic"):
        serving.load_artifact(str(junk))
    jpath = str(tmp_path / "jax.tecosrv")
    jserving.save_artifact(jpath, b"\x00" * 8, {"h": H})
    with pytest.raises(ValueError, match="bad magic"):
        serving.load_artifact(jpath)
    tpath = str(tmp_path / "torch.tecosrv")
    serving.save_artifact(tpath, blob, {"h": H})
    with pytest.raises(ValueError, match="bad magic"):
        jserving.load_artifact(tpath)


def test_save_artifact_raises_instead_of_dropping_weights(tmp_path, blob):
    path = str(tmp_path / "m.tecosrv")
    with pytest.raises(ValueError, match="state dict"):
        serving.save_artifact(path, blob, {}, params=torch.zeros(3))
    assert not osp.exists(path)


def test_wrong_weights_or_frames_fail_loudly(weights, lr, blob):
    _, sd = weights
    run = serving.load_stream(blob)
    with pytest.raises(Exception):
        run(sd, lr[:, :, :8])  # another height
    bad = dict(sd)
    bad["srnet.conv_out.weight"] = torch.zeros(3, 16, 3, 3)
    with pytest.raises(Exception):
        run(bad, lr)
    with pytest.raises(Exception):
        run({k: v.double() for k, v in sd.items()}, lr)
    with pytest.raises(ValueError, match="missing"):
        run({k: v for k, v in sd.items() if "conv_out" not in k}, lr)


def test_export_platforms(weights):
    """One platform an artifact, cuda or cpu; exporting for cuda needs a
    card on the exporting machine (here there is none)."""
    _, sd = weights
    with pytest.raises(ValueError, match="one platform"):
        serving.export_stream(sd, _cfg(), N, T, H, W, platforms=[])
    with pytest.raises(ValueError, match="exactly one platform"):
        serving.export_stream(sd, _cfg(), N, T, H, W,
                              platforms=["cpu", "cuda"])
    with pytest.raises(ValueError, match="unknown platform"):
        serving.export_stream(sd, _cfg(), N, T, H, W, platforms=["tpu"])
    if torch.cuda.is_available():
        pytest.skip("the refusal below is for a machine without a card")
    for plats in (None, ["CUDA"]):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            serving.export_stream(sd, _cfg(), N, T, H, W, platforms=plats)


def test_exporter_cli(tmp_path, weights, lr):
    params, sd = weights
    ckpt = str(tmp_path / "G_iter1.npz")
    jckpt.save_pytree(params, ckpt)
    out = str(tmp_path / "m.tecosrv")
    blob, meta = export_serving.main([
        "--ckpt", ckpt, "--out", out, "--height", str(H), "--width", str(W),
        "--frames", str(T), "--chunk", str(CHUNK), "--nf", "8", "--nb", "2",
        "--compute_dtype", "float32", "--packed16", "--platforms", "cpu"])
    run, meta_back, back = serving.load_artifact(out)
    assert meta_back == meta
    assert meta["packed16"] and meta["platforms"] == ["cpu"]
    want = infer_sequence_batch(sd, torch.from_numpy(lr),
                                _cfg(packed16=True), chunk=CHUNK)
    assert torch.equal(run(back, lr), want)
