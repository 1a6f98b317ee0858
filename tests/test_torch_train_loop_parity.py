"""The port's CLI in train mode against the JAX package's CLI
(``tecogan_tpu.main.main``): the same tiny FRVSR config, the same records
store and the same generator ``.npz``, 3 iterations in fp32 on the CPU.
A file of its own, so that the JAX step's compile takes a worker of its
own."""

import os

import numpy as np
import torch
import yaml

from tecogan_tpu import main as jax_main
from tecogan_tpu.models import base as jbase
from tecogan_tpu_torch import main as torch_main
from tecogan_tpu_torch.data.records import RecordWriter
from tecogan_tpu_torch.models import base as tbase
from tecogan_tpu_torch.models.convert import jax_from_state_dict
from tecogan_tpu_torch.models.networks import FRNet, FRNetConfig
from tecogan_tpu_torch.utils.ckpt import load_pytree, save_pytree
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_CB = {"type": "CB", "weight": 1, "reduction": "mean"}
_NF, _NB, _ITERS, _LR = 8, 2, 3, 1e-3
# tests/test_torch_train.py holds two fp32 Adam steps at lr 1e-3 to atol
# 2e-4 (Adam normalises gradients, so an update is ~lr whatever the
# gradient's size, and the tolerance covers fp32 accumulation order); three
# steps get 3e-4
_G_ATOL = 3e-4
_LOSS_RTOL = 1e-4


def _opt(root):
    return {
        "scale": 4, "manual_seed": 0, "verbose": False,
        "dataset": {
            "degradation": {"type": "BD", "sigma": 1.5},
            "train": {"name": "Toy", "seq_dir": str(root / "GT.rec"),
                      "data_type": "rgb", "crop_size": 32,
                      "batch_size_per_gpu": 2, "num_worker_per_gpu": 2,
                      "pin_memory": True},
        },
        "model": {"name": "FRVSR",
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": _NF, "nb": _NB,
                                "load_path": str(root / "G_seed.npz")}},
        "train": {"tempo_extent": 3, "start_iter": 0, "total_iter": _ITERS,
                  "moving_first_frame": True, "moving_factor": 0.7,
                  "mixed_precision": False,
                  "generator": {"lr": _LR,
                                "lr_schedule": {"type": "FixedLR"},
                                "betas": [0.9, 0.999]},
                  "pixel_crit": dict(_CB), "warping_crit": dict(_CB)},
        "test": {"test_freq": 0},
        "logger": {"log_freq": 1, "decay": 0.99, "ckpt_freq": _ITERS},
    }


def _recording(monkeypatch, base):
    """Record each batch the loop hands the model and the running log at
    each log line."""
    batches, logs = [], []
    prepare, fmt = (base.BaseVSRModel.prepare_training_data,
                    base.BaseVSRModel.get_format_msg)

    def prepare_rec(self, batch):
        batches.append({k: np.array(v) for k, v in batch.items()})
        return prepare(self, batch)

    def fmt_rec(self, state, epoch, it):
        logs.append((it, self.get_running_log(state)))
        return fmt(self, state, epoch, it)

    monkeypatch.setattr(base.BaseVSRModel, "prepare_training_data",
                        prepare_rec)
    monkeypatch.setattr(base.BaseVSRModel, "get_format_msg", fmt_rec)
    return batches, logs


def _cli(main, exp, opt, gpu_ids):
    os.makedirs(exp)
    with open(exp / "train.yml", "w") as f:
        yaml.safe_dump(opt, f)
    main(["--exp_dir", str(exp), "--mode", "train", "--opt",
          str(exp / "train.yml"), "--gpu_ids", gpu_ids])
    return load_pytree(str(exp / "train" / "ckpt" / f"G_iter{_ITERS}.npz"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix: np.asarray(tree)}


def test_port_cli_trains_like_the_jax_cli(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    w = RecordWriter(str(tmp_path / "GT.rec"))
    for vid in ("v0", "v1", "v2"):
        w.add_sequence(vid, (rng.random((3, 48, 48, 3)) * 255).astype(
            np.uint8))
    w.close()
    net = FRNet.random(FRNetConfig(nf=_NF, nb=_NB),
                       torch.Generator().manual_seed(1))
    save_pytree(jax_from_state_dict(net.state_dict(), _NB, 4),
                str(tmp_path / "G_seed.npz"))
    opt = _opt(tmp_path)

    jb, jl = _recording(monkeypatch, jbase)
    # one device each: '0' is the first of the JAX package's CPU devices,
    # '-1' the port's explicit CPU
    want = _cli(jax_main.main, tmp_path / "jax", opt, "0")
    tb, tl = _recording(monkeypatch, tbase)
    got = _cli(torch_main.main, tmp_path / "port", opt, "-1")

    assert len(jb) == len(tb) == _ITERS
    for a, b in zip(tb, jb):
        assert a.keys() == b.keys() == {"gt"}
        assert a["gt"].dtype == np.uint8 and a["gt"].shape == (2, 3, 40, 40,
                                                               3)
        np.testing.assert_array_equal(a["gt"], b["gt"])
    assert [it for it, _ in tl] == [it for it, _ in jl] == [1, 2, 3]
    for (_, a), (_, b) in zip(tl, jl):
        assert list(a) == list(b) == ["l_pix_G", "l_warp_G"]
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=_LOSS_RTOL,
                                       err_msg=k)
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    seed = _leaves(load_pytree(str(tmp_path / "G_seed.npz")))
    for k in got:
        assert not np.array_equal(got[k], seed[k]), f"{k} did not train"
        np.testing.assert_allclose(got[k], want[k], atol=_G_ATOL, err_msg=k)
