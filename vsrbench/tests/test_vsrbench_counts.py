"""The yardstick's counts against ``torch.utils.flop_counter`` run on the
plain reference at a toy size, and the warp kernels' byte counts by
hand."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vsrbench import counts, weights
from vsrbench.reference import nets as ref
from vsrbench.reference import train as rt

NF, NB, S = 16, 2, 4
# what the counter sees beyond the counts: the resamplers' and the BD
# blur's convolutions (the counts leave them out) and nothing else
TOL = 0.005


def _net(cls, *args):
    g = torch.Generator().manual_seed(1)
    return ref.load(cls(*args), weights.random_state(
        weights.layout(cls, *args), g, "cpu"), "cpu")


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_inference_flops_per_frame():
    net = _net(ref.FRNet, NF, NB, S)
    x = torch.rand(2, 3, 16, 24, 3)
    got = _flops(lambda: net.infer(x))
    want = 2 * 3 * counts.infer_frame_flops(16, 24, NF, NB, S)
    assert abs(got / want - 1) < TOL


def test_frvsr_step_flops():
    net = _net(ref.FRNet, NF, NB, S)
    adam = rt.Adam(rt.trainable(net), 1e-4)
    gt = torch.randint(0, 256, (2, 4, 72, 72, 3), dtype=torch.uint8)
    cfg = {"scale": S, "sigma": 1.5, "pixel_weight": 1, "warping_weight": 1}
    got = _flops(lambda: rt.frvsr_step(net, adam, gt, cfg))
    want = counts.generator_train_flops(2, 4, 16, 16, NF, NB, S)
    assert abs(got / want - 1) < TOL


@pytest.mark.parametrize("update_d", [True, False])
def test_tecogan_step_flops(update_d):
    net = _net(ref.FRNet, NF, NB, S)
    d = _net(ref.DTrunk, 27, 64)
    vgg = _net(ref.VGG19).requires_grad_(False)
    cfg = {"scale": S, "sigma": 1.5, "pixel_weight": 1, "warping_weight": 1,
           "d_size": 64, "crop_border_ratio": 0.75, "update_threshold": 0.4,
           "pingpong_weight": 0.5, "gan_weight": 0.01,
           "feature_weight": 0.2, "feature_layers": [8, 17, 26, 35]}
    gt = torch.randint(0, 256, (2, 4, 72, 72, 3), dtype=torch.uint8)
    got = _flops(lambda: rt.tecogan_step(
        net, d, vgg, rt.Adam(rt.trainable(net), 1e-4),
        rt.Adam(rt.trainable(d), 1e-4), gt, cfg, update_d))
    want = counts.tecogan_step_flops(2, 4, 16, 16, NF, NB, S, 64, update_d)
    assert abs(got / want - 1) < TOL


def test_the_cells_model_flops():
    # 94.4 GFLOP a 134x320 frame; 4.29 TFLOP an FRVSR step of 64 clips
    assert counts.infer_frame_flops(134, 320, 64, 10, 4) == 94438195200
    assert round(counts.generator_train_flops(64, 10, 32, 32, 64, 10, 4)
                 / 1e12, 2) == 4.29


def test_warp_bytes():
    # K1 at (4, 3, 536, 1280), bf16 image, flow and output
    px = 4 * 536 * 1280
    assert counts.warp_bytes(4, 3, 536, 1280, "bfloat16", "bfloat16") == \
        px * (3 * 2 + 2 * 2 + 3 * 2)
    # fused K3+K4: g, x (bf16, 3 ch) and the flow read; dx and dflow written
    px = 32 * 128 * 128
    assert counts.warp_adjoint_bytes(32, 3, 128, 128, "bfloat16",
                                     "bfloat16") == \
        px * (3 * 2 * 3 + 2 * 2 * 2)
    assert counts.bound_seconds(3.35e12) == 1.0
