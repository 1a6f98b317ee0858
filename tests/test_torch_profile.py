"""The port's profile mode (tecogan_tpu_torch.main --mode profile and
metrics/model_summary.py) against the JAX package's on the CPU."""

import glob
import logging
import os.path as osp
import re

import pytest
import torch
import yaml

from tecogan_tpu.main import main as jmain
from tecogan_tpu.metrics.model_summary import profile_frnet as jprofile
from tecogan_tpu.models.networks import define_generator as jdefine
from tecogan_tpu_torch import main as tmain
from tecogan_tpu_torch.metrics.model_summary import (count_params,
                                                     flop_count,
                                                     profile_frnet)
from tecogan_tpu_torch.models.networks import FRNet, define_generator
from tecogan_tpu_torch.utils.yaml_subset import safe_load

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
_TRAIN_YMLS = sorted(glob.glob(osp.join(_REPO, "experiments_*", "*", "*",
                                        "train.yml")))


@pytest.mark.parametrize("lr_size", [(3, 134, 320), (3, 37, 53)])
@pytest.mark.parametrize("yml", _TRAIN_YMLS,
                         ids=lambda p: osp.relpath(osp.dirname(p), _REPO))
def test_profile_frnet_matches_jax_for_every_shipped_generator(yml, lr_size):
    with open(yml) as f:
        opt = safe_load(f.read())
    cfg, _ = define_generator(opt)
    jcfg, _ = jdefine(opt)
    assert profile_frnet(cfg, lr_size) == jprofile(jcfg, lr_size)


def test_flagship_figures():
    """The numbers chip_smoke.py holds the card run to: 94.438 GFLOPs at
    3x134x320 (FNet 10.511, SRNet 83.927), 1.746 M + 0.844 M params."""
    with open(osp.join(_REPO, "experiments_BD", "FRVSR",
                       "FRVSR_VimeoTecoGAN_4xSR_2GPU", "train.yml")) as f:
        cfg, build = define_generator(safe_load(f.read()))
    gflops, params = profile_frnet(cfg, (3, 134, 320))
    assert (round(gflops["FNet"], 3), round(gflops["SRNet"], 3)) == (
        10.511, 83.927)
    assert round(sum(gflops.values()), 3) == 94.438
    assert params == {"FNet": 1745506, "SRNet": 843587}
    assert count_params(build(torch.Generator().manual_seed(0))) == sum(
        params.values())


def test_flop_counter_adds_the_resampling_products():
    """FlopCounterMode counts the convolutions as the analytic rule does
    (transposed ones at their input size) plus the resampling matmuls."""
    cfg, _ = define_generator({
        "scale": 4, "dataset": {"degradation": {"type": "BD"}},
        "model": {"generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": 8, "nb": 2}}})
    net = FRNet.random(cfg, torch.Generator().manual_seed(0))
    h, w = 16, 24
    args = (torch.rand(1, 3, h, w), torch.rand(1, 3, h, w),
            torch.rand(1, 3, 4 * h, 4 * w))
    gflops, _ = profile_frnet(cfg, (3, h, w))
    with torch.inference_mode():
        counted = flop_count(net.step, *args)
    # FNet's three 2x upsamplings, the flow's and the LR frame's 4x: two
    # products each, over the channels they resample
    resample = 0
    for c, hh, ww in ((256, h // 8, w // 8), (128, h // 4, w // 4),
                      (64, h // 2, w // 2)):
        resample += (2 * c * (2 * hh) * hh * ww
                     + 2 * c * (2 * hh) * ww * (2 * ww))
    for c in (2, 3):
        resample += (2 * c * 4 * h * h * w + 2 * c * 4 * h * w * 4 * w)
    assert counted == round(sum(gflops.values()) * 1e9) + resample


def _lines(records):
    return [r.getMessage() for r in records]


def _numbers(text):
    """The FLOPs, Parameters and Overall lines of a profile report."""
    keep = [ln.strip() for ln in text.splitlines()
            if ln.strip().startswith(("FLOPs (10^9)", "Parameters (10^6)",
                                      "Module:", "Overall", "Resolution"))]
    return keep


def test_profile_mode_prints_the_jax_cli_numbers(tmp_path, caplog):
    opt = {"scale": 4, "manual_seed": 0,
           "dataset": {"degradation": {"type": "BD", "sigma": 1.5}},
           "model": {"name": "FRVSR", "generator": {
               "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 8,
               "nb": 2}}}
    yml = tmp_path / "train.yml"
    yml.write_text(yaml.safe_dump(opt))
    argv = ["--exp_dir", str(tmp_path), "--mode", "profile", "--opt",
            str(yml), "--gpu_ids", "-1", "--lr_size", "3x16x24"]
    with caplog.at_level(logging.INFO, logger="base"):
        jmain(argv)
        jtext = "\n".join(_lines(caplog.records))
        caplog.clear()
        out = tmain.main(argv + ["--test_speed"])
        text = "\n".join(_lines(caplog.records))
    assert _numbers(text) == _numbers(jtext) and len(_numbers(text)) == 10
    m = re.search(r"Speed: ([\d.]+) FPS \(averaged over 30 runs\)", text)
    assert m and float(m.group(1)) > 0, text[-800:]
    assert re.search(r"FlopCounterMode: [\d.]+ GFLOPs", text)
    assert out["fps"] > 0 and out["counted_gflops"] > out["gflops"]


def test_profile_mode_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine without a card")
    opt = {"scale": 4, "dataset": {"degradation": {"type": "BD"}},
           "model": {"name": "FRVSR", "generator": {
               "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": 8,
               "nb": 2}}}
    yml = tmp_path / "train.yml"
    yml.write_text(yaml.safe_dump(opt))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmain.main(["--exp_dir", str(tmp_path), "--mode", "profile",
                    "--opt", str(yml), "--lr_size", "3x16x24"])
