"""Port parity for row-sharded single-stream inference
(``models/networks/frnet_sp.py::infer_sequence_sp``) and K1's window mode
(``ops/warp_cuda.py::warp_planes_window``): every case of
``tests/test_sp_inference.py``, each holding the port's shards on
``[cpu] * k`` against the JAX package's ``infer_sequence_sp`` on its
virtual CPU mesh, with the same weights (drawn by the port and bridged)
and inputs from a numpy seed.

Tolerances: uint8 outputs within 1 gray level on <= 0.02% of pixels, the
JAX package's own bar for sharded against unsharded (a value on a .5
rounding boundary may flip under another reduction order; torch's and
XLA's convolutions differ in it too). The window warp's plain version
against ``backward_warp_window``: atol 1e-6, fp32 (the JAX warp floors
before it clamps and the port clamps first; the weights then differ by
rounding only). Against K1's plain version on the degenerate window: bit
for bit.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import infer_sequence as jinfer
from tecogan_tpu.models.networks.frnet_sp import (
    infer_sequence_sp as jinfer_sp)
from tecogan_tpu.ops.warp import backward_warp, backward_warp_window
from tecogan_tpu.parallel import get_sp_mesh
from tecogan_tpu_torch import kernel_build
from tecogan_tpu_torch.models import vsr_model
from tecogan_tpu_torch.models.convert import jax_from_state_dict
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence,
                                               infer_sequence_sp)
from tecogan_tpu_torch.models.networks.frnet_sp import sp_geometry
from tecogan_tpu_torch.ops import warp_cuda
from tecogan_tpu_torch.ops.warp_cuda import (warp_planes_reference,
                                             warp_planes_window,
                                             warp_planes_window_reference)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _nets(nb=2, scale=4, degradation="BD"):
    cfg = FRNetConfig(nf=8, nb=nb, scale=scale, degradation=degradation)
    net = FRNet.random(cfg, torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, jax_from_state_dict(
        net.state_dict(), nb, scale))
    jcfg = JCfg(nf=8, nb=nb, scale=scale, degradation=degradation,
                compute_dtype="float32")
    return cfg, net, jcfg, params


def _assert_u8_close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    frac = np.count_nonzero(d) / d.size
    assert d.max() <= 1 and frac <= 2e-4, (d.max(), frac)


def _run_pair(rng, k, t, h, w, nb=2, scale=4, chunk=3, degradation="BD"):
    cfg, net, jcfg, params = _nets(nb, scale, degradation)
    lr = rng.random((t, h, w, 3)).astype(np.float32)
    want = np.asarray(jinfer_sp(params, jnp.asarray(lr), jcfg,
                                get_sp_mesh(k), chunk=chunk))
    got = infer_sequence_sp(net, torch.from_numpy(lr), cfg, ["cpu"] * k,
                            chunk).numpy()
    return got, want, net, cfg, lr


# -------------------------------------------------------------- the warp

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_window_warp_matches_full_warp(rng):
    """The window on the whole image: ``backward_warp_window`` within atol
    1e-6, and K1's plain version bit for bit."""
    x = rng.random((2, 40, 12, 3)).astype(np.float32)
    flow = ((rng.random((2, 40, 12, 2)) - 0.5) * 30).astype(np.float32)
    want = np.asarray(backward_warp_window(jnp.asarray(x), jnp.asarray(flow),
                                           out_y0=0, x_y0=0, h_glob=40))
    got = warp_planes_window_reference(_nchw(x), torch.from_numpy(flow),
                                       0, 0, 40)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)
    assert torch.equal(got, warp_planes_reference(_nchw(x),
                                                  torch.from_numpy(flow)))


@pytest.mark.parametrize("out_y0,pad", [(8, 24), (0, 24), (24, 8)])
def test_window_warp_slab(rng, out_y0, pad):
    """A slab with zero bands beyond the image reproduces the global warp
    on its output rows, border clamping included (the JAX test's case and
    the top and bottom windows), and agrees with ``backward_warp_window``
    on the same slab."""
    h = 64
    x = rng.random((1, h, 8, 3)).astype(np.float32)
    flow = ((rng.random((1, 32, 8, 2)) - 0.5) * 40).astype(np.float32)
    full_flow = np.pad(flow, ((0, 0), (out_y0, h - out_y0 - 32), (0, 0),
                              (0, 0)))
    full = np.asarray(backward_warp(jnp.asarray(x), jnp.asarray(full_flow)))
    full = full[:, out_y0:out_y0 + 32]
    slab = np.pad(x, ((0, 0), (pad, pad), (0, 0), (0, 0)))
    want = np.asarray(backward_warp_window(
        jnp.asarray(slab), jnp.asarray(flow), out_y0=out_y0, x_y0=-pad,
        h_glob=h))
    got = warp_planes_window(_nchw(slab), torch.from_numpy(flow), out_y0,
                             -pad, h).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-6)


def test_window_wrapper_packs_what_the_c_launcher_reads(monkeypatch):
    """The window wrapper's int64 argument array against the slots
    ``launch_window`` reads: the stream where ``arg_ptr<CUstream_st>`` looks
    and the flow's element strides where ``strides_from`` does; and the
    wrapper launches nothing on CPU tensors and refuses meta ones."""
    calls = []
    monkeypatch.setattr(warp_cuda, "launch",
                        lambda name, index, *a: calls.append((name, a)))
    monkeypatch.setattr(warp_cuda, "all_on_cpu", lambda *t: False)
    monkeypatch.setattr(warp_cuda, "cuda_index", lambda name, *t: 0)
    planes = torch.randn(2, 3, 20, 12)
    flow = torch.randn(2, 2, 8, 12).permute(0, 2, 3, 1)  # an NCHW view
    out = warp_planes_window(planes, flow, 4, -6, 40)
    assert out.shape == (2, 3, 8, 12)
    ((name, args),) = calls
    assert name == "tecogan_warp_window_f32_f32"
    text = (kernel_build.CSRC_DIR / "warp_planes.cu").read_text()
    body = re.search(r"\nint launch_window\(const int64_t\* a\) \{(.*?)\n\}",
                     text, re.S).group(1)
    (stream,) = re.findall(r"arg_ptr<CUstream_st>\(a, (\d+)\)", body)
    assert len(args) == int(stream)
    (k,) = [int(k) for k in re.findall(r"strides_from\(a \+ (\d+)\)", body)]
    assert tuple(args[k:k + 4]) == flow.stride()
    assert tuple(args[3:11]) == (2, 3, 8, 12, 20, 4, -6, 40)
    monkeypatch.undo()
    before = warp_planes_window.launches
    warp_planes_window(planes, flow, 4, -6, 40)
    assert warp_planes_window.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        warp_planes_window(planes.to("meta"), flow.to("meta"), 4, -6, 40)


# --------------------------------------------------------- the sharded path

@pytest.mark.parametrize("k,h", [(2, 128), (4, 256)])
def test_sp_matches_jax(rng, k, h):
    """Windows clamped to the image (k=2) and real interior crops + 2-hop
    border halos (k=4, v=64, b2=360)."""
    got, want, net, cfg, lr = _run_pair(rng, k=k, t=5, h=h, w=16)
    _assert_u8_close(got, want)
    if k == 4:
        geo = sp_geometry(cfg, h, k)
        assert (geo["b2"], geo["hops"], geo["l_sr"]) == (360, 2, 128)
    # and the port's own unsharded path
    _assert_u8_close(got, infer_sequence(net, torch.from_numpy(lr), cfg,
                                         3).numpy())


def test_sp_matches_jax_fnet_sliced(rng):
    """h=384, k=4 -> v=96: l_fn = 352 < h, the FNet window is a strict
    slice; also crosses a chunk boundary (t=7, chunk=3)."""
    got, want, _, cfg, _ = _run_pair(rng, k=4, t=7, h=384, w=8, chunk=3)
    assert sp_geometry(cfg, 384, 4)["l_fn"] == 352
    _assert_u8_close(got, want)


def test_sp_matches_jax_2x(rng):
    """scale=2 halo arithmetic (reach 50 -> 56, b2 = 184)."""
    got, want, _, cfg, _ = _run_pair(rng, k=4, t=4, h=256, w=16, scale=2)
    assert sp_geometry(cfg, 256, 4)["b2"] == 184
    _assert_u8_close(got, want)


def test_sp_matches_jax_bi(rng):
    """BI degradation: the bicubic half-pixel global residual windows."""
    got, want, *_ = _run_pair(rng, k=4, t=4, h=256, w=16, degradation="BI")
    _assert_u8_close(got, want)


def test_sp_one_device_falls_back(rng):
    """k=1 is ``infer_sequence``, bit for bit, as JAX's is its own."""
    cfg, net, jcfg, params = _nets()
    lr = rng.random((3, 64, 16, 3)).astype(np.float32)
    got = infer_sequence_sp(net, torch.from_numpy(lr), cfg, ["cpu"],
                            3).numpy()
    np.testing.assert_array_equal(
        got, infer_sequence(net, torch.from_numpy(lr), cfg, 3).numpy())
    want = np.asarray(jinfer_sp(params, jnp.asarray(lr), jcfg,
                                get_sp_mesh(1), chunk=3))
    np.testing.assert_array_equal(
        want, np.asarray(jinfer(params, jnp.asarray(lr), jcfg, chunk=3)))
    _assert_u8_close(got, want)


def _model_opt(spatial_partition):
    return {
        "scale": 4, "manual_seed": 0, "device_ids": [],
        "dataset": {"degradation": {"type": "BD", "sigma": 1.5}},
        "model": {"name": "FRVSR",
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": 8, "nb": 2}},
        "test": {"padding_mode": "reflect", "num_pad_front": 2,
                 "spatial_partition": spatial_partition},
    }


def test_model_infer_spatial_partition_flag(rng, monkeypatch):
    """``test.spatial_partition: true`` routes ``VSRModel.infer`` through
    the row-sharded path over the model's devices (the largest fitting
    count) with matching output; a height no count fits falls back to the
    one-device path; the flag off never shards."""
    from tecogan_tpu_torch.models import define_model

    calls = []
    real = vsr_model.infer_sequence_sp
    monkeypatch.setattr(vsr_model, "infer_sequence_sp",
                        lambda *a: calls.append(len(a[3])) or real(*a))
    cpu4 = [torch.device("cpu")] * 4
    lr = rng.random((5, 64, 16, 3)).astype(np.float32)
    ref_model = define_model(_model_opt(False))
    ref_model.devices = cpu4
    ref = ref_model.infer(lr, chunk=3)
    m = define_model(_model_opt(True))
    m.devices = cpu4
    m.net_g.load_state_dict(ref_model.net_g.state_dict())
    got = m.infer(lr, chunk=3)
    _assert_u8_close(got, ref)
    assert calls == [4]  # 64 rows: 4 shards of 16
    assert m.sp_devices(24) == cpu4[:3]  # 24 rows: 3 shards of 8
    # h=8: every k>=2 gives h/k < 8 rows a shard -> one device
    lr_small = rng.random((5, 8, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(m.infer(lr_small, chunk=3),
                                  ref_model.infer(lr_small, chunk=3))
    assert calls == [4]


def test_sp_rejects_misaligned_rows():
    cfg, net, jcfg, params = _nets()
    for h, msg in ((120, "multiple of 8"), (130, "not divisible")):
        lr = np.zeros((3, h, 16, 3), np.float32)
        with pytest.raises(ValueError, match=msg):
            jinfer_sp(params, jnp.asarray(lr), jcfg, get_sp_mesh(4))
        with pytest.raises(ValueError, match=msg):
            infer_sequence_sp(net, torch.from_numpy(lr), cfg, ["cpu"] * 4)
