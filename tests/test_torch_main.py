"""Port parity for test mode end to end: ``tecogan_tpu_torch.main`` on the
CPU (``--gpu_ids -1``) against ``tecogan_tpu.main`` (JAX on the CPU) on one
tree of PNG test sets and one ``.npz`` generator checkpoint."""

import json
import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax

from tecogan_tpu.main import main as jax_main
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.models.networks import init_frnet
from tecogan_tpu.ops.degrade import imresize_matlab
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch.main import main as torch_main

_NF, _NB = 8, 2
_T, _H, _W = 5, 48, 56
_METRIC = {"PSNR": {"colorspace": "y"}, "SSIM": None,
           "tOF": {"colorspace": "y"}}


def _save_ckpt(path, key):
    params = init_frnet(jax.random.PRNGKey(key),
                        JCfg(nf=_NF, nb=_NB, scale=4, pallas_warp=False))
    jckpt.save_pytree(jax.tree.map(np.asarray, params), path)


def _gt_clip(rng):
    """(t, h, w, 3) uint8: a smooth image drifting by a pixel a frame."""
    base = rng.random((_H + 8, _W + 8, 3))
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = (base - base.min()) / (base.max() - base.min())
    return np.stack([(base[i:i + _H, i:i + _W] * 255).round()
                     .astype(np.uint8) for i in range(_T)])


def _write_seq(seq_dir, frames):
    os.makedirs(seq_dir)
    for i, f in enumerate(frames):
        cv2.imwrite(osp.join(seq_dir, f"{i:04d}.png"), f[..., ::-1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """BD set (GT only, two sequences), BI set (GT + LR made by the JAX
    package's imresize_matlab, one sequence), one checkpoint."""
    root = tmp_path_factory.mktemp("test_mode")
    rng = np.random.default_rng(0)
    for seq in ("calendar", "city"):
        _write_seq(str(root / "BD_GT" / seq), _gt_clip(rng))
    gt = _gt_clip(rng)
    _write_seq(str(root / "BI_GT" / "walk"), gt)
    lr = imresize_matlab(gt.astype(np.float64) / 255.0, scale=0.25)
    _write_seq(str(root / "BI_LR" / "walk"),
               np.clip(np.round(lr * 255.0), 0, 255).astype(np.uint8))
    _save_ckpt(str(root / "G_iter1.npz"), 3)
    _save_ckpt(str(root / "G_iter2.npz"), 4)
    return root


def _opt(root, degradation, exp, model="FRVSR", load_path=None):
    test_set = ({"name": "Vid4", "gt_seq_dir": str(root / "BD_GT")}
                if degradation == "BD" else
                {"name": "ToS3", "gt_seq_dir": str(root / "BI_GT"),
                 "lr_seq_dir": str(root / "BI_LR")})
    deg = ({"type": "BD", "sigma": 1.5} if degradation == "BD"
           else {"type": "BI"})
    return {
        "scale": 4, "manual_seed": 0, "verbose": False,
        "dataset": {"degradation": deg, "test1": {
            **test_set, "num_worker_per_gpu": 1, "pin_memory": True}},
        "model": {"name": model, "generator": {
            "name": "FRNet", "in_nc": 3, "out_nc": 3, "nf": _NF, "nb": _NB,
            "load_path": load_path or str(root / "G_iter1.npz")}},
        "test": {"save_res": True, "res_dir": str(exp / "results"),
                 "save_json": True, "json_dir": str(exp / "metrics"),
                 "padding_mode": "reflect", "num_pad_front": 2},
        "metric": _METRIC,
    }


def _run(cli_main, opt, exp, gpu_ids="-1"):
    os.makedirs(exp, exist_ok=True)
    with open(osp.join(exp, "test.yml"), "w") as f:
        yaml.safe_dump(opt, f)
    return cli_main(["--exp_dir", str(exp), "--mode", "test",
                     "--opt", osp.join(exp, "test.yml"),
                     "--gpu_ids", gpu_ids])


def _tree_files(d):
    return sorted(osp.relpath(osp.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _json(exp, name):
    with open(osp.join(exp, "metrics", f"{name}_avg.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("degradation,ds", [("BD", "Vid4"), ("BI", "ToS3")])
def test_cli_matches_jax(tree, degradation, ds):
    jexp, texp = tree / f"jax_{degradation}", tree / f"torch_{degradation}"
    _run(jax_main, _opt(tree, degradation, jexp), jexp, gpu_ids="0")
    records = _run(torch_main, _opt(tree, degradation, texp), texp)

    files = _tree_files(jexp / "results")
    assert files == _tree_files(texp / "results")
    gt_dir = tree / ("BD_GT" if degradation == "BD" else "BI_GT")
    assert files == [osp.join(ds, "G_iter1", f) for f in _tree_files(gt_dir)]
    for f in files:
        want = cv2.imread(str(jexp / "results" / f)).astype(np.int32)
        got = cv2.imread(str(texp / "results" / f)).astype(np.int32)
        assert got.shape == want.shape == (_H, _W, 3)
        assert np.abs(got - want).max() <= 1, f

    jj, tj = _json(jexp, ds), _json(texp, ds)
    assert list(tj) == ["G_iter1"] and list(tj["G_iter1"]) == list(_METRIC)
    assert abs(float(tj["G_iter1"]["PSNR"])
               - float(jj["G_iter1"]["PSNR"])) <= 0.05
    assert abs(float(tj["G_iter1"]["SSIM"])
               - float(jj["G_iter1"]["SSIM"])) <= 1e-3
    assert np.isfinite(float(tj["G_iter1"]["tOF"]))
    seqs = sorted(os.listdir(gt_dir))
    assert [r["seq_idx"] for r in records] == seqs
    assert all(r["frames"] == _T and r["model_idx"] == "G_iter1"
               for r in records)


def test_checkpoint_sweep(tree):
    """``load_path: <dir>/*.npz`` with test.{start_iter,end_iter,
    test_freq} runs both checkpoints through one model and writes an
    entry for each; different weights give different PSNR."""
    exp = tree / "sweep"
    opt = _opt(tree, "BD", exp, load_path=str(tree / "*.npz"))
    opt["test"].update({"start_iter": 1, "end_iter": 2, "test_freq": 1})
    records = _run(torch_main, opt, exp)
    d = _json(exp, "Vid4")
    assert list(d) == ["G_iter1", "G_iter2"]
    assert d["G_iter1"]["PSNR"] != d["G_iter2"]["PSNR"], d
    assert all(np.isfinite(float(v)) for e in d.values() for v in e.values())
    assert [r["model_idx"] for r in records] == ["G_iter1"] * 2 + [
        "G_iter2"] * 2
    for it in (1, 2):
        assert len(_tree_files(exp / "results" / "Vid4" / f"G_iter{it}")) \
            == 2 * _T


def test_tecogan_test_yml_runs_the_generator(tree):
    """A TecoGAN test.yml runs through VSRGANModel: the same generator
    checkpoint gives FRVSR's PNGs bit for bit."""
    exp = tree / "tecogan"
    _run(torch_main, _opt(tree, "BI", exp, model="TecoGAN"), exp)
    ref = tree / "torch_BI"
    if not osp.isdir(ref / "results"):
        _run(torch_main, _opt(tree, "BI", ref), ref)
    files = _tree_files(exp / "results")
    assert files == _tree_files(ref / "results") and files
    for f in files:
        np.testing.assert_array_equal(cv2.imread(str(exp / "results" / f)),
                                      cv2.imread(str(ref / "results" / f)))


@pytest.mark.parametrize("mode", ["train", "profile"])
def test_unported_modes_raise(tree, mode):
    """Train and profile mode are ported, so each goes on to read its YAML
    (missing here) and raises there, having written nothing."""
    exp = tree / f"mode_{mode}"
    os.makedirs(exp)
    with pytest.raises(FileNotFoundError, match="missing.yml"):
        torch_main(["--exp_dir", str(exp), "--mode", mode, "--opt",
                    str(exp / "missing.yml"), "--gpu_ids", "-1"])
    assert os.listdir(exp) == []


def test_cli_requires_cuda_or_explicit_cpu(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    exp = tree / "no_cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(torch_main, _opt(tree, "BD", exp), exp, gpu_ids="0")
    with pytest.raises(ValueError, match="Unrecognized mode"):
        torch_main(["--exp_dir", str(exp), "--mode", "serve", "--opt",
                    str(exp / "test.yml")])
