"""The port's serving host (tecogan_tpu_torch.serve) on the CPU, on PNG
trees: against the JAX package's ``serve.main`` on the same weights
(within 1 gray level, the same file names), pre-roll, the ``--ckpt``
override, JPEG frames in, the refusals, and a host that imports none of
the port's models."""

import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tecogan_tpu import serve as jserve
from tecogan_tpu import serving as jserving
from tecogan_tpu.models.networks import FRNetConfig as JCfg
from tecogan_tpu.utils import ckpt as jckpt
from tecogan_tpu_torch import serve, serving
from tecogan_tpu_torch.models.convert import (jax_from_state_dict,
                                              state_dict_from_jax)
from tecogan_tpu_torch.models.networks import (FRNet, FRNetConfig,
                                               infer_sequence_batch)
from tecogan_tpu_torch.utils.png import read_image, read_png, write_png
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
N, T, H, W, CHUNK = 1, 5, 16, 24, 4


@pytest.fixture(scope="module")
def weights():
    """The JAX pytree (numpy leaves) and the port's state dict of it, drawn
    by the port."""
    net = FRNet.random(_cfg(), torch.Generator().manual_seed(3))
    params = jax_from_state_dict(net.state_dict())
    return params, state_dict_from_jax(params)


def _cfg():
    return FRNetConfig(nf=8, nb=2, scale=4)


@pytest.fixture(scope="module")
def blob(weights):
    return serving.export_stream(weights[1], _cfg(), N, T, H, W,
                                 chunk=CHUNK, platforms=["cpu"])


def _write_tree(root, rng, lengths, ext=".png"):
    """Sequences of uint8 frames under root/<name>/, PNG (or another
    extension through cv2)."""
    frames = {}
    for name, t in lengths.items():
        seq = (rng.random((t, H, W, 3)) * 255).astype(np.uint8)
        os.makedirs(osp.join(root, name))
        for i, img in enumerate(seq):
            path = osp.join(root, name, f"{i:04d}{ext}")
            if ext == ".png":
                write_png(path, img)
            else:
                import cv2

                cv2.imwrite(path, img[..., ::-1])
        frames[name] = seq
    return frames


def _read_tree(root, frames):
    return {name: np.stack([read_png(osp.join(root, name, f"{i:04d}.png"))
                            for i in range(len(seq))])
            for name, seq in frames.items()}


def test_serve_matches_jax_serve(tmp_path, weights):
    """Both hosts on one PNG tree, 2 streams an artifact and 3 sequences
    (a filler slot in the second group), one shorter than t: the same file
    names and frames within 1 gray level."""
    params, sd = weights
    t = 6
    frames = _write_tree(str(tmp_path / "in"), np.random.default_rng(1),
                         {"a": t, "b": t - 2, "c": 3})
    jart, art = str(tmp_path / "j.tecosrv"), str(tmp_path / "t.tecosrv")
    meta = {"n": 2, "t": t, "h": H, "w": W, "scale": 4, "nf": 8, "nb": 2}
    jcfg = JCfg(nf=8, nb=2, scale=4, pallas_warp=False)
    jserving.save_artifact(jart, jserving.export_stream(
        params, jcfg, 2, t, H, W, chunk=CHUNK), meta, params=params)
    serving.save_artifact(art, serving.export_stream(
        sd, _cfg(), 2, t, H, W, chunk=CHUNK, platforms=["cpu"]), meta,
        params=sd)
    jserve.main([jart, str(tmp_path / "in"), str(tmp_path / "jout"),
                 "--quiet"])
    assert serve.main([art, str(tmp_path / "in"), str(tmp_path / "out"),
                       "--quiet"]) == {"a": t, "b": t - 2, "c": 3}
    for name in frames:
        assert (sorted(os.listdir(tmp_path / "out" / name))
                == sorted(os.listdir(tmp_path / "jout" / name)))
    got = _read_tree(str(tmp_path / "out"), frames)
    want = _read_tree(str(tmp_path / "jout"), frames)
    for name in frames:
        assert np.abs(got[name].astype(np.int32) - want[name]).max() <= 1


def test_serve_pre_roll_ckpt_override_and_refusals(tmp_path, weights):
    """--pad_front is test mode's reflect pre-roll (trimmed), --ckpt serves
    a weights-free artifact, JPEG frames in give PNG frames out, and the
    ambiguous layout and a sequence too long for t are refused."""
    params, sd = weights
    t = 8
    rng = np.random.default_rng(2)
    frames = _write_tree(str(tmp_path / "in"), rng, {"clip": 5})
    art = str(tmp_path / "m.tecosrv")
    serving.save_artifact(art, serving.export_stream(
        sd, _cfg(), 1, t, H, W, chunk=CHUNK, platforms=["cpu"]),
        {"n": 1, "t": t, "h": H, "w": W, "scale": 4, "nb": 2})
    ckpt = str(tmp_path / "G.npz")
    jckpt.save_pytree(params, ckpt)
    with pytest.raises(ValueError, match="no embedded weights"):
        serve.serve(art, str(tmp_path / "in"), str(tmp_path / "x"),
                    quiet=True)
    serve.main([art, str(tmp_path / "in"), str(tmp_path / "out"), "--ckpt",
                ckpt, "--pad_front", "3", "--quiet"])
    lr = frames["clip"].astype(np.float32) / 255.0
    padded = np.concatenate([lr[1:4][::-1], lr, lr[-1:]])[None]
    want = infer_sequence_batch(sd, torch.from_numpy(padded), _cfg(),
                                chunk=CHUNK)[0, 3:8].numpy()
    got = _read_tree(str(tmp_path / "out"), frames)["clip"]
    np.testing.assert_array_equal(got, want)

    # JPEG in, PNG out: the frames the host read, as cv2 decodes them
    pytest.importorskip("cv2")
    _write_tree(str(tmp_path / "jpg"), rng, {"clip": 4}, ext=".jpg")
    serve.main([art, str(tmp_path / "jpg"), str(tmp_path / "jout"), "--ckpt",
                ckpt, "--quiet"])
    assert sorted(os.listdir(tmp_path / "jout" / "clip")) == [
        f"{i:04d}.png" for i in range(4)]
    read = np.stack([read_image(str(tmp_path / "jpg" / "clip" /
                                          f"{i:04d}.jpg"))
                     for i in range(4)]).astype(np.float32) / 255.0
    padded = np.concatenate([read] + [read[-1:]] * (t - 4))[None]
    want = infer_sequence_batch(sd, torch.from_numpy(padded), _cfg(),
                                chunk=CHUNK)[0, :4].numpy()
    got = np.stack([read_png(str(tmp_path / "jout" / "clip" / f"{i:04d}.png"))
                    for i in range(4)])
    np.testing.assert_array_equal(got, want)

    write_png(str(tmp_path / "in" / "stray.png"), frames["clip"][0])
    with pytest.raises(ValueError, match="both loose image frames"):
        serve.discover_sequences(str(tmp_path / "in"))
    os.remove(tmp_path / "in" / "stray.png")
    with pytest.raises(ValueError, match="exceeds the artifact's fixed t"):
        serve.main([art, str(tmp_path / "in"), str(tmp_path / "out2"),
                    "--ckpt", ckpt, "--pad_front", "4", "--quiet"])


def test_serving_host_imports_no_models(tmp_path, weights, blob):
    """The serving host loads and runs an artifact with the port's models,
    jax, yaml and cv2 unimportable."""
    art = str(tmp_path / "m.tecosrv")
    serving.save_artifact(art, blob, {"n": N, "t": T, "h": H, "w": W,
                                      "scale": 4, "nb": 2},
                          params=weights[1])
    _write_tree(str(tmp_path / "in"), np.random.default_rng(4), {"s": T})
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "tecogan_tpu", "yaml", "cv2"):
                    raise ImportError("blocked: " + name)
                if name.startswith("tecogan_tpu_torch.models"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        from tecogan_tpu_torch import serve
        written = serve.main([{art!r}, {str(tmp_path / 'in')!r},
                              {str(tmp_path / 'out')!r}, "--quiet"])
        assert written == {{"s": {T}}}
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=_REPO, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
