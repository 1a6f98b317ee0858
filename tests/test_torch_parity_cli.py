"""The port's one-command parity run (``tools/run_parity.py``) rehearsed on
the CPU, as ``tests/test_weights_rehearsal.py::test_run_parity_one_command``
rehearses ``scripts/run_parity.py``: a synthesized reference-format FRNet
``.pth`` (nf=8, nb=2) and two 8-frame GT sequences through one command,
then the JAX script on the same tree.

The SR PNGs of the two commands are equal (as ``tests/test_torch_main.py``
holds the two CLIs' PNGs), so the harnesses score the same frames: PSNR,
SSIM and tOF agree to every digit the CSV prints. No LPIPS weights are
present, so both skip LPIPS and tLP100 with a warning.
"""

import argparse
import os
import os.path as osp
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml

from tecogan_tpu_torch.models.networks import FRNet, FRNetConfig
from tecogan_tpu_torch.tools import run_parity
from tecogan_tpu_torch.utils.png import read_image
from tecogan_tpu_torch.utils.yaml_subset import safe_load

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
_COLS = ("PSNR", "SSIM", "tOF")


@pytest.fixture
def tree(tmp_path, rng, monkeypatch):
    """A checkpoint and data/Vid4/GT with two 8-frame sequences of
    48x56, under a CWD without LPIPS weights."""
    monkeypatch.chdir(tmp_path)
    net = FRNet.random(FRNetConfig(nf=8, nb=2, scale=4),
                       torch.Generator().manual_seed(2))
    torch.save(net.state_dict(), str(tmp_path / "G_iter2.pth"))
    gt_root = tmp_path / "data" / "Vid4" / "GT"
    for seq in ("calendar", "city"):
        seq_dir = gt_root / seq
        seq_dir.mkdir(parents=True)
        base = (rng.random((48, 56, 3)) * 255).astype(np.uint8)
        for i in range(8):
            cv2.imwrite(str(seq_dir / f"{i:04d}.png"),
                        np.roll(base, i * 2, axis=1)[..., ::-1])
    return tmp_path


def _args(tmp, workdir):
    return ["--ckpt", str(tmp / "G_iter2.pth"),
            "--gt_root", str(tmp / "data" / "Vid4" / "GT"),
            "--degradation", "BD", "--scale", "4", "--model", "FRVSR",
            "--nf", "8", "--nb", "2", "--workdir", str(tmp / workdir)]


def _pngs(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".png"))


def test_run_parity_one_command_matches_the_jax_script(tree, capsys):
    got = run_parity.main(_args(tree, "ours"), device="cpu")
    out = capsys.readouterr().out
    assert "WARNING: LPIPS/tLP100 disabled" in out
    assert "=== FRVSR_BD_G_iter2 on Vid4 (2 sequences) ===" in out
    assert "north-star tOF within 1%" in out
    csv_path = (tree / "ours" / "results" / "Vid4" / "FRVSR_BD_G_iter2" /
                "metric_log" / "metrics.csv")
    assert run_parity.parse_frame_avg(str(csv_path)) == got
    assert set(got) == set(_COLS)
    assert all(np.isfinite(got[c]) for c in _COLS), got
    assert got["PSNR"] > 5.0 and 0 < got["SSIM"] <= 1 and got["tOF"] >= 0

    sys.path.insert(0, osp.join(_REPO, "scripts"))
    try:
        import run_parity as jax_run_parity
    finally:
        sys.path.pop(0)
    jax_run_parity.main(_args(tree, "theirs"))
    assert "WARNING: LPIPS/tLP100 disabled" in capsys.readouterr().out
    res = osp.join("exp", "test", "results", "Vid4", "G_iter2")
    ours, theirs = tree / "ours" / res, tree / "theirs" / res
    names = _pngs(ours)
    assert len(names) == 16 and names == _pngs(theirs)
    for name in names:
        np.testing.assert_array_equal(read_image(str(ours / name)),
                                      read_image(str(theirs / name)),
                                      err_msg=name)
    want = jax_run_parity.parse_frame_avg(str(
        tree / "theirs" / "results" / "Vid4" / "FRVSR_BD_G_iter2" /
        "metric_log" / "metrics.csv"))
    assert set(want) == set(_COLS)
    for c in _COLS:
        assert got[c] == want[c], (c, got[c], want[c])


def test_run_parity_writes_a_test_yml_the_subset_reads(tree):
    """The test.yml the tool writes reads back through the port's YAML
    reader (and PyYAML) as the config it built."""
    args = _args(tree, "ours")
    run_parity.main(args, device="cpu")
    with open(tree / "ours" / "exp" / "test.yml") as f:
        text = f.read()
    parsed = argparse.Namespace(
        ckpt=args[1], gt_root=args[3], lr_root=None, degradation="BD",
        scale=4, dataset="Vid4", nf=8, nb=2)
    want = run_parity.build_test_opt(parsed)
    assert safe_load(text) == want == yaml.safe_load(text)
    assert want["dataset"]["test1"]["lr_seq_dir"] is None


def test_run_parity_refuses_bi_without_lr(tree):
    with pytest.raises(SystemExit, match="needs --lr_root"):
        run_parity.main(_args(tree, "ours")[:5] + ["BI"], device="cpu")
