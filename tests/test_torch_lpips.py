"""The port's LPIPS (tecogan_tpu_torch.metrics.lpips) against the JAX
package's on the CPU: the three trunks and the distance at random
torchvision-format weights, the gates, and LPIPS in the metric
calculator.

Tolerances: fp32 on both sides, the same operations in another
framework's convolution code, so each trunk's taps agree to rtol 1e-4
(atol 1e-5 of the tap's scale) and distances and maps to rtol 1e-4."""

import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tecogan_tpu.metrics import lpips as jlpips
from tecogan_tpu.metrics.metric_calculator import MetricCalculator as JCalc
from tecogan_tpu_torch.metrics import lpips
from tecogan_tpu_torch.metrics.metric_calculator import MetricCalculator
from tecogan_tpu_torch.utils.ckpt import save_pytree
from torch_oracles import (rand_alexnet_sd, rand_squeezenet_sd,
                           rand_vgg16_sd)

_RAND = {"alex": rand_alexnet_sd, "vgg": rand_vgg16_sd,
         "squeeze": rand_squeezenet_sd}
_JAX_FEATURES = {"alex": (jlpips.convert_alexnet, jlpips.alexnet_features),
                 "vgg": (jlpips.convert_vgg16, jlpips.vgg16_features),
                 "squeeze": (jlpips.convert_squeezenet,
                             jlpips.squeezenet_features)}


def _weights(tmp_path, rng, net):
    """Random backbone and v0.1 heads saved as .pth files; returns their
    paths."""
    bb_stem, lin_stem = lpips._NET_FILES[net]
    bb = str(tmp_path / f"{bb_stem}.pth")
    lin = str(tmp_path / f"{lin_stem}.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _RAND[net](rng).items()},
               bb)
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32) * 0.1)
        for i, c in enumerate(lpips._NET_CHANS[net])}, lin)
    return bb, lin


@pytest.mark.parametrize("hw", [(64, 64), (67, 45)])
@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
@torch.no_grad()
def test_trunk_matches_jax(rng, net, hw):
    """Each trunk's taps against the JAX trunk on the same torchvision
    weights; the odd size exercises the floor pools and SqueezeNet's ceil
    pools on a partial last window."""
    sd = _RAND[net](rng)
    trunk = lpips._TRUNKS[net]()
    trunk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    x = rng.random((1, *hw, 3)).astype(np.float32)
    convert, features = _JAX_FEATURES[net]
    want = features(convert(sd), jnp.asarray(x))
    got = trunk(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1,
                                                                   2))))
    assert len(got) == len(want) == len(lpips._NET_CHANS[net])
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("net", ["alex", "vgg", "squeeze"])
def test_distance_matches_jax(tmp_path, rng, net, spatial):
    bb, lin = _weights(tmp_path, rng, net)
    ours = lpips.LPIPS(net, bb, lin, spatial=spatial, device="cpu")
    theirs = jlpips.LPIPS(net, bb, lin, spatial=spatial)
    a = (rng.random((2, 50, 61, 3)) * 255).astype(np.uint8)
    b = (rng.random((2, 50, 61, 3)) * 255).astype(np.uint8)
    got, want = ours(a, b), theirs(a, b)
    assert got.shape == want.shape == ((2, 50, 61) if spatial else (2,))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)
    one = ours(a[0], a[0])
    assert one.shape == ((1, 50, 61) if spatial else (1,))
    assert np.abs(one).max() < 1e-6


def test_npz_weights_in_the_jax_layout(tmp_path, rng):
    """A backbone and heads saved in the JAX package's converted layout
    give the .pth weights' distance."""
    bb, lin = _weights(tmp_path, rng, "squeeze")
    sd = {k: v.numpy() for k, v in torch.load(bb).items()}
    save_pytree(jlpips.convert_squeezenet(sd), str(tmp_path / "bb.npz"))
    heads = jlpips.convert_lin_heads(
        {k: v.numpy() for k, v in torch.load(lin).items()}, 7)
    save_pytree(tuple(heads), str(tmp_path / "lin.npz"))
    a = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    b = (rng.random((48, 48, 3)) * 255).astype(np.uint8)
    want = lpips.LPIPS("squeeze", bb, lin, device="cpu")(a, b)
    got = lpips.LPIPS("squeeze", str(tmp_path / "bb.npz"),
                      str(tmp_path / "lin.npz"), device="cpu")(a, b)
    np.testing.assert_array_equal(got, want)


def test_gates_heads_and_alias(tmp_path, rng, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="weights unavailable"):
        lpips.LPIPS(device="cpu")
    with pytest.raises(ValueError, match="unknown LPIPS backbone"):
        lpips.LPIPS("resnet", device="cpu")
    # alexnet heads on the vgg trunk: the channel check refuses them
    _, alex_lin = _weights(tmp_path, rng, "alex")
    vgg_bb, _ = _weights(tmp_path, rng, "vgg")
    with pytest.raises(ValueError, match="wrong checkpoint"):
        lpips.LPIPS("vgg", vgg_bb, alex_lin, device="cpu")
    # 'vgg16' is 'vgg', and the weights are found where the JAX package
    # looks for them
    os.makedirs("pretrained_models/lpips")
    _weights(tmp_path / "pretrained_models" / "lpips", rng, "vgg")
    assert lpips.find_lpips_weights(net="vgg16") == (
        "pretrained_models/lpips/vgg16.pth", "pretrained_models/lpips/vgg.pth")
    assert lpips.LPIPS("vgg16", device="cpu").net == "vgg"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lpips.LPIPS("vgg")


@pytest.mark.parametrize("spatial", [False, True])
def test_metric_calculator_matches_jax(tmp_path, rng, monkeypatch, caplog,
                                       spatial):
    """PSNR, SSIM and LPIPS over a sequence, the port's calculator against
    the JAX one, both finding the weights under pretrained_models/lpips;
    with ``spatial`` the top-left map pixel (the reference's quirk)."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("pretrained_models/lpips")
    _weights(tmp_path / "pretrained_models" / "lpips", rng, "alex")
    metric = {"PSNR": {"colorspace": "y"}, "SSIM": None,
              "LPIPS": {"net": "alex", "spatial": spatial}}
    gt = (rng.random((3, 48, 56, 3)) * 255).astype(np.uint8)
    sr = np.clip(gt.astype(np.int32) + rng.integers(-20, 20, gt.shape), 0,
                 255).astype(np.uint8)
    with caplog.at_level(logging.INFO, logger="base"):
        ours = MetricCalculator({"metric": metric, "device_ids": []})
    assert not [r for r in caplog.records if r.levelno == logging.WARNING]
    theirs = JCalc({"metric": metric})
    for calc in (ours, theirs):
        calc.compute_sequence_metrics("s", gt, sr)
        calc.gather(["s"])
    assert list(ours.metric_dict["s"]["LPIPS"]) and len(
        ours.metric_dict["s"]["LPIPS"]) == 3
    np.testing.assert_allclose(ours.metric_dict["s"]["LPIPS"],
                               theirs.metric_dict["s"]["LPIPS"], rtol=1e-4)
    for m in ("PSNR", "SSIM"):
        assert ours.avg_metric_dict["s"][m] == theirs.avg_metric_dict["s"][m]
    assert ours.average()["LPIPS"] == pytest.approx(
        theirs.average()["LPIPS"], rel=1e-4)
