"""The port's official metric harness (tecogan_tpu_torch.official_metrics)
against the JAX package's on one PNG tree (CPU): the per-folder CSV
series, the Avg / FolderAvg / FrameAvg rows and the summary (PSNR, SSIM
and tOF within 1e-6 relative; LPIPS, at random weights, and tLP100 as
``RTOL`` says), with LPIPS and tLP100 and without; and the JAX harness's
refusals."""

import csv
import os
import os.path as osp

import numpy as np
import pytest
import torch

from tecogan_tpu.official_metrics import evaluate as jevaluate
from tecogan_tpu.official_metrics import metrics as jmetrics
from tecogan_tpu_torch.metrics import lpips
from tecogan_tpu_torch.official_metrics import evaluate, metrics
from tecogan_tpu_torch.utils.png import write_png
from torch_oracles import rand_alexnet_sd

# PSNR, SSIM and tOF are the same numpy and cv2 code on both sides: 1e-6
# relative. LPIPS is fp32 convolutions in two frameworks: 1e-4 relative,
# as tests/test_torch_lpips.py holds it. tLP100 is 100 x the difference of
# two such nearly equal distances, so it is held to 100 x 2e-4 of the
# largest LPIPS value absolute
RTOL = {"PSNR": 1e-6, "SSIM": 1e-6, "tOF": 1e-6, "LPIPS": 1e-4}


def _close(got, want, metric, lpips_max):
    if metric == "tLP100":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=100 * 2e-4 * lpips_max)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL[metric])


def _write_seq(root, n, h=96, w=120, seed=0, noise=0.0):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = rng.random((h, w, 3)) * 255
    for i in range(n):
        img = np.roll(base, i * 3, axis=1)
        if noise:
            img = img + rng.normal(0, noise, img.shape)
        write_png(osp.join(root, f"{i:04d}.png"),
                  np.clip(img, 0, 255).astype(np.uint8))


def _tree(root):
    """Two sequences of results and targets, one of them too short for
    tOF."""
    for seq, n, seed in (("a", 8, 3), ("b", 5, 4)):
        _write_seq(osp.join(root, "gt", seq), n, seed=seed)
        _write_seq(osp.join(root, "sr", seq), n, seed=seed, noise=6.0)


def _lpips_weights(root, rng):
    d = osp.join(root, "pretrained_models", "lpips")
    os.makedirs(d)
    torch.save({k: torch.from_numpy(v) for k, v in
                rand_alexnet_sd(rng).items()}, osp.join(d, "alexnet.pth"))
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1)).astype(np.float32) * 0.1)
        for i, c in enumerate(lpips._NET_CHANS["alex"])},
        osp.join(d, "alex.pth"))


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _same_csv(got, want, lpips_max):
    """The same rows and columns, numbers within each metric's tolerance
    (the metric is the column's name up to its "_")."""
    assert len(got) == len(want)
    header = None
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        if not g[0]:  # a header row
            assert g == w
            header = g
            continue
        assert g[0] == w[0]  # the index
        for name, a, b in zip(header[1:], g[1:], w[1:]):
            assert bool(a) == bool(b), (g, w)  # empty on one side only
            if a:
                metric = name.split("_")[1 if name[0] in "AF" else 0]
                _close(float(a), float(b), metric, lpips_max)


@pytest.mark.parametrize("with_lpips", [False, True])
def test_evaluate_folders_matches_jax(tmp_path, rng, monkeypatch,
                                      with_lpips):
    monkeypatch.chdir(tmp_path)
    _tree(str(tmp_path))
    if with_lpips:
        _lpips_weights(str(tmp_path), rng)
    dirs = ([str(tmp_path / "sr")], [str(tmp_path / "gt")])
    want = jmetrics.evaluate_folders(*dirs, str(tmp_path / "jlog"))
    got = metrics.evaluate_folders(*dirs, str(tmp_path / "log"),
                                   device="cpu")
    keys = ["PSNR", "SSIM", "tOF"] + (["LPIPS", "tLP100"] if with_lpips
                                      else [])
    assert list(got) == list(want) == keys
    lpips_max = 0.0
    if with_lpips:
        header = None
        for r in _rows(tmp_path / "jlog" / "metrics.csv"):
            if not r[0]:
                header = r
                continue
            lpips_max = max([lpips_max] + [
                float(v) for name, v in zip(header, r)
                if name.startswith("LPIPS_") and v])
    for k in keys:
        assert got[k][0] == want[k][0]
        _close(got[k][1:], want[k][1:], k, lpips_max)
    assert got["tOF"][0] == 3  # the 5-frame sequence scores no tOF
    _same_csv(_rows(tmp_path / "log" / "metrics.csv"),
              _rows(tmp_path / "jlog" / "metrics.csv"), lpips_max)
    with open(tmp_path / "log" / "metricsfile.txt") as f, open(
            tmp_path / "jlog" / "metricsfile.txt") as g:
        lines, jlines = f.read().splitlines(), g.read().splitlines()
    assert lines[:2] == jlines[:2] and len(lines) == len(jlines) == 2 + len(
        keys)


def test_lpips_column_is_the_metric_calculators(tmp_path, rng,
                                                monkeypatch):
    """The CSV's LPIPS series equals LPIPS of the cropped frame pairs, as
    the metric calculator computes it frame by frame."""
    monkeypatch.chdir(tmp_path)
    _write_seq(str(tmp_path / "gt"), 7, seed=5)
    _write_seq(str(tmp_path / "sr"), 7, seed=5, noise=8.0)
    _lpips_weights(str(tmp_path), rng)
    metrics.evaluate_folders([str(tmp_path / "sr")], [str(tmp_path / "gt")],
                             str(tmp_path / "log"), device="cpu")
    rows = _rows(tmp_path / "log" / "metrics.csv")
    col = rows[0].index("LPIPS_00")
    series = [float(r[col]) for r in rows[1:4]]
    metric = lpips.LPIPS(device="cpu")
    want = []
    for i in range(2, 5):
        tar = metrics.read_image(str(tmp_path / "gt" / f"{i:04d}.png"))
        out = metrics.read_image(str(tmp_path / "sr" / f"{i:04d}.png"))
        want.append(metric(metrics.crop_32(tar)[0],
                           metrics.crop_32(out)[0])[0])
    assert np.float32(series).tolist() == np.float32(want).tolist()


def test_refusals_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_seq(str(tmp_path / "gt"), 4, seed=1)
    _write_seq(str(tmp_path / "sr"), 4, seed=1)
    for harness, kw in ((jmetrics, {}), (metrics, {"device": "cpu"})):
        with pytest.raises(SystemExit, match="pair positionally"):
            harness.evaluate_folders(["a", "b"], ["a"], "o", **kw)
        with pytest.raises(SystemExit, match="no scorable"):
            harness.evaluate_folders(["missing"], ["missing_t"], "o", **kw)
        with pytest.raises(SystemExit, match="no frames were scorable"):
            harness.evaluate_folders([str(tmp_path / "sr")],
                                     [str(tmp_path / "gt")], "o", **kw)
        with pytest.raises(ValueError, match="too small"):
            harness.crop_32(np.zeros((40, 64, 3), np.uint8))
    for cli in (jevaluate, evaluate):
        with pytest.raises(SystemExit, match="must be named"):
            cli.main(["-m", "ESRGAN_BD", "--gpu_ids", "-1"][
                :2 if cli is jevaluate else 4])
        with pytest.raises(SystemExit, match="no results found"):
            cli.main(["-m", "TecoGAN_BD_x", "--gpu_ids", "-1"][
                :2 if cli is jevaluate else 4])


def test_evaluate_cli_and_device(tmp_path, rng, monkeypatch):
    """The benchmark entry on a Vid4-shaped tree, on the CPU when asked;
    without CUDA and without that request it raises."""
    monkeypatch.chdir(tmp_path)
    for seq in evaluate.VID4_SEQS:
        _write_seq(str(tmp_path / "data" / "Vid4" / "GT" / seq), 6, seed=2)
        _write_seq(str(tmp_path / "results" / "Vid4" / "FRVSR_BD_x" / seq),
                   6, seed=2, noise=4.0)
    _lpips_weights(str(tmp_path), rng)
    out = evaluate.main(["-m", "FRVSR_BD_x", "--gpu_ids", "-1"])
    assert list(out) == ["Vid4"] and out["Vid4"]["PSNR"][0] == 8
    assert out["Vid4"]["tLP100"][0] == 4
    assert osp.exists("results/Vid4/FRVSR_BD_x/metric_log/metrics.csv")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            evaluate.main(["-m", "FRVSR_BD_x"])
