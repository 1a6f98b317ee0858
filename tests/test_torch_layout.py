"""The generator's memory layout on the CPU: a bf16 FNet and SRNet run
every convolution channels_last (input and weight), an fp32 one NCHW, both
take and return contiguous NCHW tensors, and bf16's outputs are an NCHW
composition's of the same weights; ``networks.nhwc_forwards`` and
``networks.nchw_forwards`` count one forward each, by route. Tiny nets (nf
8, nb 1-2) drawn by the port."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tecogan_tpu_torch.models import schedules, steps
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
from tecogan_tpu_torch.models.networks import frnet
from tecogan_tpu_torch.ops.resize import upsample_bilinear
from tecogan_tpu_torch.ops.spatial import space_to_depth
from tecogan_tpu_torch.utils import tracing

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_S, _H, _W = 4, 16, 24
_CB = {"type": "CB", "weight": 1, "reduction": "mean"}
_CL = torch.channels_last


def _net(dtype, nb=1, seed=0):
    net = FRNet.random(FRNetConfig(nf=8, nb=nb, scale=_S),
                       torch.Generator().manual_seed(seed))
    return net.to(dtype)


def _channels_last(t):
    """Laid out NHWC and not NCHW (no shape here is ambiguous)."""
    return t.is_contiguous(memory_format=_CL) and not t.is_contiguous()


def _inputs(dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    lr = torch.rand(2, 3, _H, _W, generator=g).to(dtype)
    prev = torch.rand(2, 3, _H, _W, generator=g).to(dtype)
    hr = torch.rand(2, 3, _S * _H, _S * _W, generator=g).to(dtype)
    return lr, prev, hr


def _masked_call(net, dtype):
    """SRNet's row-masked form on two streams folded along rows, as
    ``stream_frames(fold_streams=True)`` calls it."""
    n = 2
    cfg = net.cfg
    _, ph, band = frnet._fold_geometry(_S, _H)
    masks = frnet._fold_masks(_S, n, _H, ph, band, dtype)
    mh = torch.from_numpy(frnet._fold_residual_mh(cfg, n, _H, ph))
    g = torch.Generator().manual_seed(2)
    lr = torch.rand(1, 3, n * ph, _W, generator=g).to(dtype) * masks["lr"]
    hr = torch.rand(1, 3, n * band, _S * _W, generator=g).to(dtype)
    packed = space_to_depth(hr * masks["planes"], _S)
    return net.srnet.forward_packed(lr, packed, row_masks=masks,
                                    residual_mh=mh)


def _call(net, path, dtype):
    lr, prev, hr = _inputs(dtype)
    if path == "fnet":
        return net.fnet(lr, prev)
    if path == "srnet":
        return net.srnet(lr, hr)
    if path == "srnet_packed":
        return net.srnet.forward_packed(lr, space_to_depth(hr, _S))
    return _masked_call(net, dtype)


@pytest.mark.parametrize("path", ["fnet", "srnet", "srnet_packed",
                                  "srnet_masked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_convolutions_see_the_layout_of_the_dtype(path, dtype):
    net = _net(dtype)
    seen = []

    def hook(module, args):
        seen.append((type(module).__name__, args[0], module.weight))

    for m in net.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        out = _call(net, path, dtype)
    convs = 14 if path == "fnet" else 1 + 2 * 1 + 2 + 1
    assert len(seen) == convs
    for name, x, w in seen:
        assert x.dtype == w.dtype == dtype
        if dtype == torch.bfloat16:
            assert _channels_last(x) and _channels_last(w), name
        else:
            assert x.is_contiguous() and w.is_contiguous(), name
    assert out.dtype == dtype and out.is_contiguous()


def _conv(m, x):
    """``m`` on NCHW ``x`` with an NCHW copy of its weight."""
    w = m.weight.contiguous()
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, m.bias, m.stride, m.padding,
                                  m.output_padding)
    return F.conv2d(x, w, m.bias, m.stride, m.padding)


def _seq(seq, x):
    for m in seq:
        x = _conv(m, x) if isinstance(m, (nn.Conv2d,
                                          nn.ConvTranspose2d)) else m(x)
        assert x.is_contiguous()
    return x


def _srnet_nchw(sr, lr, hr):
    out = torch.cat([lr, space_to_depth(hr, sr.scale)], 1).contiguous()
    out = _seq(sr.conv_in, out)
    for block in sr.resblocks:
        out = out + _seq(block.conv, out)
    out = _seq(sr.conv_up, out)
    return _conv(sr.conv_out, out) + sr.upsample(lr)


def _fnet_nchw(fn, cur, prev):
    out = torch.cat([cur, prev], 1).contiguous()
    out = _seq(fn.encoder3, _seq(fn.encoder2, _seq(fn.encoder1, out)))
    for dec in (fn.decoder1, fn.decoder2, fn.decoder3):
        out = upsample_bilinear(_seq(dec, out), 2)
    return torch.tanh(_seq(fn.flow, out)) * 24.0


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_outputs_equal_an_nchw_composition(seed):
    net = _net(torch.bfloat16, nb=2, seed=seed)
    lr, prev, hr = _inputs(torch.bfloat16, seed=seed + 3)
    with torch.no_grad():
        assert torch.equal(net.srnet(lr, hr), _srnet_nchw(net.srnet, lr, hr))
        got, want = net.fnet(lr, prev), _fnet_nchw(net.fnet, lr, prev)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=1e-3)


def test_weights_follow_the_dtype_through_casts():
    net = _net(torch.float32)
    convs = [m.weight for m in net.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    assert all(w.is_contiguous() for w in convs)
    net = net.to(torch.bfloat16)
    assert all(_channels_last(p) for p in net.parameters() if p.dim() == 4)
    net = net.float()
    assert all(p.is_contiguous() for p in net.parameters())
    # a bf16 copy for inference leaves the fp32 net as it was
    fp32 = _net(torch.float32)
    cast = frnet._compute_module(fp32, torch.bfloat16)
    assert all(_channels_last(p) for p in cast.parameters() if p.dim() == 4)
    assert all(p.is_contiguous() and p.dtype == torch.float32
               for p in fp32.parameters())


def _delta(run):
    c0 = tracing.counters()
    run()
    c1 = tracing.counters()
    return (c1["networks.nhwc_forwards"] - c0["networks.nhwc_forwards"],
            c1["networks.nchw_forwards"] - c0["networks.nchw_forwards"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_streaming_counts_one_forward_a_chunk_and_a_frame_step(dtype):
    cfg = FRNetConfig(nf=8, nb=1, scale=_S, compute_dtype=dtype)
    net = FRNet.random(cfg, torch.Generator().manual_seed(0))
    t, chunk = 7, 3  # 3 chunks of 3 frame steps, 2 of them padding
    k, c = 3, 3
    lr = torch.rand(2, t, _H, _W, 3,
                    generator=torch.Generator().manual_seed(4))
    got = _delta(lambda: infer_sequence_batch(net, lr, cfg, chunk=chunk))
    want = k + k * c
    assert got == ((want, 0) if dtype == "bfloat16" else (0, want))


def test_mixed_precision_training_step_counts_nhwc_alone():
    cfg = FRNetConfig(nf=8, nb=1, scale=_S, remat=True)
    net = FRNet.random(cfg, torch.Generator().manual_seed(0))
    opt, sched = schedules.make_adam({"lr": 1e-4}, net.parameters())
    state = steps.frvsr_init_state(net, opt)
    tcfg = steps.TrainConfig(scale=_S, degradation="BD", sigma=1.5,
                             pixel_crit=_CB, warping_crit=_CB,
                             mixed_precision=True)
    t = 3
    gt = torch.from_numpy((np.random.default_rng(0).random(
        (1, t, 40, 40, 3)) * 255).astype(np.uint8))
    got = _delta(lambda: steps.frvsr_train_step(
        state, {"gt": gt}, cfg_g=cfg, tcfg=tcfg, sched_g=sched))
    # FNet once over the clip's pairs, SRNet once a frame and once again
    # in the backward's recomputation (remat)
    assert got == (1 + 2 * t, 0)
    assert all(p.is_contiguous() and p.dtype == torch.float32
               for p in net.parameters())
