"""The port's offline tools against the JAX package's scripts on the CPU:
``tools/convert_checkpoint.py`` (against ``scripts/convert_checkpoint.py``),
``tools/resize_bd.py`` and ``tools/generate_lr_bi.py`` (against
``scripts/resize_bd.py`` and ``scripts/generate_lr_bi.py``), each script
loaded with importlib and run on the same inputs.

The offline LR frames are held against the arrays the JAX scripts hand to
``cv2.imwrite``: the port writes every frame as a lossless PNG, where the
JAX script's cv2 writes JPEG for a ``.jpg`` name. BD runs the same float32
operator matrices in another summation order (``downsample_bd`` is held
at atol 1e-6 in ``tests/test_torch_ops.py``), so a value on a rounding tie
may land one gray level away: at most 1 level on at most 0.1% of the
values (measured: none). BI computes in float64 on both sides: equal.
"""

import importlib.util
import os
import os.path as osp
import sys

import cv2
import numpy as np
import pytest
import torch

from tecogan_tpu_torch.models.networks import (VGG19, DTrunk, FRNet,
                                               FRNetConfig, STNetConfig)
from tecogan_tpu_torch.tools import (convert_checkpoint, generate_lr_bi,
                                     resize_bd)
from tecogan_tpu_torch.utils.png import read_image

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# BD: at most 1 gray level on at most this share of the values
_BD_MAX_SHARE = 1e-3


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", osp.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(monkeypatch, name, args):
    """``scripts/<name>.py``'s main with ``args`` as its command line."""
    mod = _load_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    mod.main()


# ------------------------------------------------------ convert_checkpoint

def _vgg_like(rng):
    """A torchvision-named VGG19 state dict at toy widths (the converters
    only transpose) plus a classifier entry, which both ignore."""
    sd = {}
    cin = 3
    for idx in sorted(VGG19.random(torch.Generator().manual_seed(0))
                      .state_dict()):
        if not idx.endswith(".weight"):
            continue
        name = idx[:-len(".weight")]
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.standard_normal((4, cin, 3, 3)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            rng.standard_normal(4).astype(np.float32))
        cin = 4
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    return sd


def _sources(tmp_path, rng):
    gen = torch.Generator().manual_seed(0)
    srcs = {
        "frnet": FRNet.random(FRNetConfig(nf=8, nb=2), gen).state_dict(),
        "stnet": DTrunk.random(STNetConfig(spatial_size=32),
                               gen).state_dict(),
        "vgg19": _vgg_like(rng),
    }
    paths = {}
    for kind, sd in srcs.items():
        paths[kind] = str(tmp_path / f"{kind}.pth")
        torch.save(sd, paths[kind])
    return srcs, paths


def _npz(path):
    with np.load(path) as z:
        return [(k, z[k]) for k in z.files]


@pytest.mark.parametrize("kind", ["frnet", "stnet", "vgg19"])
def test_convert_pth_to_npz_matches_the_jax_script(tmp_path, rng,
                                                   monkeypatch, kind):
    """The same .pth through both CLIs: the .npz files hold the same keys
    in the same order, shapes, dtypes and values."""
    _, paths = _sources(tmp_path, rng)
    extra = (["--nb", "2", "--scale", "4"] if kind == "frnet" else
             ["--spatial_size", "32"] if kind == "stnet" else [])
    ours, theirs = str(tmp_path / "ours.npz"), str(tmp_path / "theirs.npz")
    convert_checkpoint.main(["--src", paths[kind], "--dst", ours, "--kind",
                             kind, *extra])
    _run_script(monkeypatch, "convert_checkpoint",
                ["--src", paths[kind], "--dst", theirs, "--kind", kind,
                 *extra])
    got, want = _npz(ours), _npz(theirs)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_convert_npz_to_pth_round_trips(tmp_path, rng, monkeypatch):
    """.pth -> .npz -> .pth gives the reference state dict back, and the
    exported .pth equals the JAX script's export of the same .npz."""
    srcs, paths = _sources(tmp_path, rng)
    npz = str(tmp_path / "G.npz")
    convert_checkpoint.main(["--src", paths["frnet"], "--dst", npz, "--nb",
                             "2"])
    ours, theirs = str(tmp_path / "ours.pth"), str(tmp_path / "theirs.pth")
    convert_checkpoint.main(["--src", npz, "--dst", ours, "--nb", "2"])
    _run_script(monkeypatch, "convert_checkpoint",
                ["--src", npz, "--dst", theirs, "--nb", "2"])
    got = torch.load(ours, weights_only=True)
    want = torch.load(theirs, weights_only=True)
    assert set(got) == set(want) == set(srcs["frnet"])
    for k, v in srcs["frnet"].items():
        assert torch.equal(got[k], v) and torch.equal(want[k], v), k
    with pytest.raises(SystemExit, match="only frnet"):
        convert_checkpoint.main(["--src", npz, "--dst", ours, "--kind",
                                 "stnet"])


# ------------------------------------------------- resize_bd, generate_lr_bi

@pytest.fixture
def gt_tree(tmp_path, rng):
    """Two sequences of 38x53 frames (not a multiple of 4: BI modcrops),
    one holding a JPEG frame, and a stray file beside them."""
    root = tmp_path / "GT"
    for seq, names in (("a", ["0000.png", "0001.png", "0002.jpg"]),
                       ("b", [f"{i:04d}.png" for i in range(4)])):
        os.makedirs(root / seq)
        base = (rng.random((38, 60, 3)) * 255).astype(np.uint8)
        for i, name in enumerate(names):
            cv2.imwrite(str(root / seq / name), base[:, i:i + 53])
    (root / "README.txt").write_text("not a sequence")
    return root


def _jax_frames(monkeypatch, name, args):
    """Run the JAX script; {path: the RGB array it handed to cv2.imwrite}."""
    seen = {}
    real = cv2.imwrite

    def recording(path, img, *a):
        seen[path] = np.ascontiguousarray(img[..., ::-1])
        return real(path, img, *a)

    monkeypatch.setattr(cv2, "imwrite", recording)
    _run_script(monkeypatch, name, args)
    monkeypatch.setattr(cv2, "imwrite", real)
    return seen


def _compare(ours_root, theirs_root, seen):
    """(max gray-level difference, share of values that differ) of the
    port's frames against the JAX script's arrays, frame by frame under
    the same relative names."""
    diffs = []
    for path, want in sorted(seen.items()):
        rel = osp.relpath(path, theirs_root)
        got = read_image(osp.join(ours_root, rel))
        assert got.shape == want.shape, rel
        diffs.append(np.abs(got.astype(int) - want.astype(int)).ravel())
    assert sorted(osp.relpath(p, theirs_root) for p in seen) == sorted(
        osp.relpath(osp.join(d, f), ours_root)
        for d, _, fs in os.walk(ours_root) for f in fs)
    d = np.concatenate(diffs)
    return int(d.max()), float((d > 0).mean())


def test_resize_bd_matches_the_jax_script(tmp_path, gt_tree, monkeypatch):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    resize_bd.main(["--gt_dir", str(gt_tree), "--lr_dir", str(ours),
                    "--scale", "4"], device="cpu")
    seen = _jax_frames(monkeypatch, "resize_bd",
                       ["--gt_dir", str(gt_tree), "--lr_dir", str(theirs),
                        "--scale", "4"])
    assert len(seen) == 7 and osp.exists(ours / "a" / "0002.jpg")
    assert read_image(str(ours / "b" / "0000.png")).shape == (10, 14, 3)
    worst, share = _compare(str(ours), str(theirs), seen)
    assert worst <= 1 and share <= _BD_MAX_SHARE, (worst, share)


def test_generate_lr_bi_matches_the_jax_script(tmp_path, gt_tree,
                                               monkeypatch):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    generate_lr_bi.main(["--gt_dir", str(gt_tree), "--lr_dir",
                         str(ours / "lr"), "--up_dir", str(ours / "up"),
                         "--scale", "4"], device="cpu")
    seen = _jax_frames(monkeypatch, "generate_lr_bi",
                       ["--gt_dir", str(gt_tree), "--lr_dir",
                        str(theirs / "lr"), "--up_dir", str(theirs / "up"),
                        "--scale", "4"])
    assert len(seen) == 14
    assert read_image(str(ours / "lr" / "a" / "0002.jpg")).shape == (9, 13,
                                                                     3)
    assert read_image(str(ours / "up" / "b" / "0003.png")).shape == (36, 52,
                                                                     3)
    assert _compare(str(ours), str(theirs), seen) == (0, 0.0)


def test_tools_need_a_card_unless_asked(tmp_path, gt_tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for tool in (resize_bd, generate_lr_bi):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--gt_dir", str(gt_tree), "--lr_dir",
                       str(tmp_path / "lr")])
