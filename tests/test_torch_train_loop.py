"""The port's CLI in train mode on the CPU (``python -m tecogan_tpu_torch.main
--mode train --gpu_ids -1``) with a tiny FRVSR config: the JAX loop's log
line and cadence, checkpoints, validation, auto-resume that continues the
data stream, the emergency save, the device-resident loader, TecoGAN and
BI."""

import json
import os
import os.path as osp
import re
import subprocess

import numpy as np
import pytest
import torch
import yaml

from tecogan_tpu_torch import main as torch_main
from tecogan_tpu_torch.data import loader as loader_mod
from tecogan_tpu_torch.data.records import RecordWriter
from tecogan_tpu_torch.models import vsr_model
from tecogan_tpu_torch.utils.ckpt import load_pytree
from tecogan_tpu_torch.utils.png import write_png

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
_LOG_LINE = re.compile(
    r"^\[epoch: (\d+) \| iter: (\d+) \| lr_G: (\d\.\d\de[-+]\d\d)"
    r"(?: \| lr_D: (\d\.\d\de[-+]\d\d))?\] (.*)$")
_CB = {"type": "CB", "weight": 1, "reduction": "mean"}



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are tiny, and under a parallel
    test run torch's thread pool in every worker oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _frames(rng, t, h, w):
    return (rng.random((t, h, w, 3)) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A BD store of 2 sequences x 3 frames of 48x48 (6 samples: 3
    iterations an epoch at batch 2), a BI pair of stores (64x64 GT, 16x16
    LR) and a PNG test set of one 4-frame sequence."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("data")
    gt = RecordWriter(str(root / "GT.rec"))
    for vid in ("v0", "v1"):
        gt.add_sequence(vid, _frames(rng, 3, 48, 48))
    gt.close()
    bi_gt, bi_lr = (RecordWriter(str(root / "BI_GT.rec")),
                    RecordWriter(str(root / "BI_LR.rec")))
    for vid in ("p0", "p1"):
        f = _frames(rng, 3, 64, 64)
        bi_gt.add_sequence(vid, f)
        bi_lr.add_sequence(vid, f[:, ::4, ::4].copy())
    bi_gt.close()
    bi_lr.close()
    os.makedirs(root / "ValGT" / "seq_x")
    for i in range(4):
        write_png(str(root / "ValGT" / "seq_x" / f"{i:04d}.png"),
                  _frames(rng, 1, 32, 40)[0])
    return root


def _opt(data, total_iter=4, log_freq=1, ckpt_freq=2, test_freq=0,
         mixed=False, **dataset):
    """tests/test_cli.py's tiny FRVSR train.yml: nf=8, nb=2, crop 32,
    tempo_extent 3, batch 2 from a 2-sequence store (3 iterations an
    epoch)."""
    return {
        "scale": 4, "manual_seed": 0, "verbose": False,
        "dataset": {
            "degradation": {"type": "BD", "sigma": 1.5},
            "train": {"name": "Toy", "seq_dir": str(data / "GT.rec"),
                      "data_type": "rgb", "crop_size": 32,
                      "batch_size_per_gpu": 2, "num_worker_per_gpu": 2,
                      "pin_memory": True, **dataset},
            "test": {"name": "Val", "gt_seq_dir": str(data / "ValGT"),
                     "num_worker_per_gpu": 1, "pin_memory": True},
        },
        "model": {"name": "FRVSR",
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": 8, "nb": 2,
                                "compute_dtype": ("bfloat16" if mixed
                                                  else "float32")}},
        "train": {"tempo_extent": 3, "start_iter": 0,
                  "total_iter": total_iter, "moving_first_frame": True,
                  "moving_factor": 0.7, "mixed_precision": mixed,
                  "generator": {"lr": 1e-3,
                                "lr_schedule": {"type": "FixedLR"},
                                "betas": [0.9, 0.999]},
                  "pixel_crit": dict(_CB), "warping_crit": dict(_CB)},
        "test": {"test_freq": test_freq, "save_res": False,
                 "res_dir": None, "save_json": True, "json_dir": None,
                 "padding_mode": "reflect", "num_pad_front": 2},
        "metric": {"PSNR": {"colorspace": "y"}},
        "logger": {"log_freq": log_freq, "decay": 0.99,
                   "ckpt_freq": ckpt_freq},
    }


def _run(exp, opt, gpu_ids="-1"):
    os.makedirs(exp, exist_ok=True)
    with open(osp.join(exp, "train.yml"), "w") as f:
        yaml.safe_dump(opt, f)
    return torch_main.main(["--exp_dir", str(exp), "--mode", "train",
                            "--opt", osp.join(exp, "train.yml"),
                            "--gpu_ids", gpu_ids])


def _ckpts(exp):
    d = osp.join(exp, "train", "ckpt")
    return sorted(os.listdir(d)) if osp.isdir(d) else []


def _log_lines(caplog):
    return [m for m in (r.getMessage() for r in caplog.records)
            if _LOG_LINE.match(m)]


def _state(exp, it):
    return torch.load(osp.join(exp, "train", "ckpt", f"state_iter{it}.pth"),
                      map_location="cpu", weights_only=True)


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for net in ("g", "opt_g", "d", "opt_d"):
        if net not in a:
            continue
        fa, fb = _flat(a[net]), _flat(b[net])
        assert fa.keys() == fb.keys()
        for k in fa:
            if isinstance(fa[k], torch.Tensor):
                assert torch.equal(fa[k], fb[k]), (net, k)
            else:
                assert fa[k] == fb[k], (net, k)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def test_log_lines_checkpoints_and_validation(tmp_path, data, caplog):
    exp = tmp_path / "exp"
    with caplog.at_level("INFO", logger="base"):
        model = _run(exp, _opt(data, total_iter=5, log_freq=2, ckpt_freq=2,
                               test_freq=2))
    assert isinstance(model, vsr_model.VSRModel)
    assert model.state["step"] == 5
    lines = _log_lines(caplog)
    assert [int(_LOG_LINE.match(m).group(2)) for m in lines] == [2, 4]
    for m in lines:
        ep, it, lr_g, lr_d, rest = _LOG_LINE.match(m).groups()
        assert lr_g == "1.00e-03" and lr_d is None
        assert int(ep) == (int(it) - 1) // 3
        keys = [kv.split(": ")[0] for kv in rest.split(", ")]
        assert keys == ["l_pix_G", "l_warp_G"]
        assert all(np.isfinite(float(kv.split(": ")[1]))
                   for kv in rest.split(", "))
    # ckpt_freq 2 and the final iteration 5
    assert _ckpts(exp) == ["G_iter2.npz", "G_iter4.npz", "G_iter5.npz",
                           "state_iter2.pth", "state_iter4.pth",
                           "state_iter5.pth"]
    assert set(load_pytree(str(exp / "train/ckpt/G_iter5.npz"))) == {
        "fnet", "srnet"}
    with open(exp / "test" / "metrics" / "Val_avg.json") as f:
        metrics = json.load(f)
    assert list(metrics) == ["G_iter2", "G_iter4"]
    assert all(np.isfinite(float(v["PSNR"])) for v in metrics.values())


def test_no_checkpoints_with_ckpt_freq_0(tmp_path, data):
    exp = tmp_path / "exp"
    _run(exp, _opt(data, total_iter=2, log_freq=0, ckpt_freq=0))
    assert _ckpts(exp) == []


def test_resumed_run_with_the_budget_spent_trains_nothing(tmp_path, data,
                                                          caplog):
    exp = tmp_path / "exp"
    _run(exp, _opt(data, total_iter=2))
    path = exp / "train" / "ckpt" / "state_iter2.pth"
    mtime = os.path.getmtime(path)
    caplog.clear()  # the first run's lines, where "base" already logs INFO
    with caplog.at_level("INFO", logger="base"):
        model = _run(exp, _opt(data, total_iter=2))
    assert model.state["step"] == 2
    assert _log_lines(caplog) == []
    assert _ckpts(exp) == ["G_iter2.npz", "state_iter2.pth"]
    assert os.path.getmtime(path) == mtime


@pytest.mark.parametrize("stop", [3, 4])
def test_resume_continues_the_data_stream(tmp_path, data, stop):
    """A run interrupted at iteration 3 (the end of epoch 0) or 4 (inside
    epoch 1) and resumed to 5 ends bit-identical to a straight run to 5
    (weights and Adam state): the resumed run enters epoch 1 at batch
    stop - 3."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    _run(straight, _opt(data, total_iter=5, ckpt_freq=5, log_freq=0))
    _run(resumed, _opt(data, total_iter=stop, ckpt_freq=stop, log_freq=0))
    seen = []
    epoch = loader_mod.TrainLoader.epoch

    def recording(self, epoch_idx, start_batch=0):
        seen.append((epoch_idx, start_batch))
        return epoch(self, epoch_idx, start_batch)

    try:
        loader_mod.TrainLoader.epoch = recording
        _run(resumed, _opt(data, total_iter=5, ckpt_freq=5, log_freq=0))
    finally:
        loader_mod.TrainLoader.epoch = epoch
    assert seen == [(1, stop - 3)]
    _assert_same_state(_state(straight, 5), _state(resumed, 5))
    a = load_pytree(str(straight / "train/ckpt/G_iter5.npz"))
    b = load_pytree(str(resumed / "train/ckpt/G_iter5.npz"))
    for k in a:
        for j in a[k]:
            for n in a[k][j]:
                np.testing.assert_array_equal(a[k][j][n], b[k][j][n])


@pytest.mark.parametrize("mixed", [False, True])
def test_validation_leaves_training_untouched(tmp_path, data, mixed):
    """Validation every 2 iterations (inference mode, a bf16 copy of the
    weights for a bf16 generator, fp32 inference numerics) leaves the
    weights and Adam state after 4 iterations bit-identical to a run
    without validation."""
    runs = {}
    for test_freq in (2, 0):
        exp = tmp_path / f"val{test_freq}"
        _run(exp, _opt(data, total_iter=4, ckpt_freq=4, log_freq=0,
                       test_freq=test_freq, mixed=mixed))
        runs[test_freq] = _state(exp, 4)
    assert osp.exists(tmp_path / "val2" / "test" / "metrics" / "Val_avg.json")
    _assert_same_state(runs[2], runs[0])


def test_emergency_save_after_a_loader_failure(tmp_path, data, caplog):
    exp = tmp_path / "exp"
    epoch = loader_mod.TrainLoader.epoch

    def failing(self, epoch_idx, start_batch=0):
        for k, batch in enumerate(epoch(self, epoch_idx, start_batch)):
            if k == 2:
                raise OSError("the store went away")
            yield batch

    try:
        loader_mod.TrainLoader.epoch = failing
        with caplog.at_level("INFO", logger="base"), \
                pytest.raises(OSError, match="went away"):
            _run(exp, _opt(data, total_iter=5, ckpt_freq=0))
    finally:
        loader_mod.TrainLoader.epoch = epoch
    assert _ckpts(exp) == ["state_iter2.pth"]
    assert _state(exp, 2)["step"] == 2
    assert any("Emergency training state saved at iter 2" in r.getMessage()
               for r in caplog.records)
    # the run resumes from it
    model = _run(exp, _opt(data, total_iter=3, ckpt_freq=0))
    assert model.state["step"] == 3


def test_a_failed_emergency_save_is_logged(tmp_path, data, caplog,
                                           monkeypatch):
    epoch = loader_mod.TrainLoader.epoch

    def failing(self, epoch_idx, start_batch=0):
        yield from epoch(self, epoch_idx, start_batch)
        raise OSError("the store went away")

    def no_space(self, state, it):
        raise OSError("No space left on device")

    monkeypatch.setattr(loader_mod.TrainLoader, "epoch", failing)
    monkeypatch.setattr(vsr_model.VSRModel, "save_training_state", no_space)
    with caplog.at_level("INFO", logger="base"), \
            pytest.raises(OSError, match="went away"):
        _run(tmp_path / "exp", _opt(data, total_iter=5, ckpt_freq=0))
    errors = [r for r in caplog.records if r.levelname == "ERROR"]
    assert len(errors) == 1
    assert "Emergency training-state save FAILED at iter 3" in (
        errors[0].getMessage())
    assert "No space left" in caplog.text


def test_leaving_mid_epoch_stops_the_loader(tmp_path, data):
    """2 of an epoch's 3 iterations: the loop returns with the loader's
    producer and workers stopped."""
    import threading
    import time

    before = set(threading.enumerate())
    _run(tmp_path / "exp", _opt(data, total_iter=2, ckpt_freq=0))
    deadline = time.time() + 10.0
    while time.time() < deadline:
        extra = [t for t in threading.enumerate()
                 if t not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"leaked threads: {extra}"


def test_no_emergency_save_after_a_failed_step(tmp_path, data, caplog,
                                               monkeypatch):
    exp = tmp_path / "exp"
    train = vsr_model.VSRModel.train
    calls = []

    def failing(self, batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("CUDA error: an illegal memory access")
        return train(self, batch)

    monkeypatch.setattr(vsr_model.VSRModel, "train", failing)
    with caplog.at_level("INFO", logger="base"), \
            pytest.raises(RuntimeError, match="illegal memory"):
        _run(exp, _opt(data, total_iter=5, ckpt_freq=2))
    assert _ckpts(exp) == ["G_iter2.npz", "state_iter2.pth"]
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Emergency save impossible") and
               m.endswith("resume from the last periodic checkpoint")
               for m in msgs), msgs


def test_device_resident_loader_trains_like_the_host_loader(tmp_path, data):
    runs = []
    for resident in (False, True):
        exp = tmp_path / f"resident{resident}"
        model = _run(exp, _opt(data, total_iter=3, ckpt_freq=3, log_freq=0,
                               device_resident=resident))
        assert type(model).__name__ == "VSRModel"
        runs.append(_state(exp, 3))
    _assert_same_state(*runs)


def test_tecogan_through_the_cli(tmp_path, data, caplog):
    opt = _opt(data, total_iter=2, log_freq=1, ckpt_freq=2)
    opt["model"]["name"] = "TecoGAN"
    opt["model"]["discriminator"] = {"name": "STNet", "in_nc": 3,
                                     "tempo_range": 3}
    opt["train"].update({
        "feature_crit": {"type": "CosineSimilarity", "weight": 0.2,
                         "reduction": "mean", "feature_layers": [8, 17],
                         "allow_random_weights": True,
                         "weights_path": str(tmp_path / "vgg19.npz")},
        "pingpong_crit": {**_CB, "weight": 0.5},
        "gan_crit": {"type": "GAN", "weight": 0.01, "reduction": "mean"},
        "discriminator": {"lr": 5e-5, "update_policy": "adaptive",
                          "update_threshold": 0.4,
                          "crop_border_ratio": 0.75,
                          "lr_schedule": {"type": "FixedLR"}}})
    exp = tmp_path / "gan"
    with caplog.at_level("INFO", logger="base"):
        model = _run(exp, opt)
    assert type(model).__name__ == "VSRGANModel"
    assert _ckpts(exp) == ["D_iter2.npz", "G_iter2.npz", "state_iter2.pth"]
    lines = _log_lines(caplog)
    assert len(lines) == 2
    for m in lines:
        groups = _LOG_LINE.match(m).groups()
        assert groups[3] == "5.00e-05"  # lr_D
        assert "l_gan_G" in groups[4] and "n_upd_D" in groups[4]


def test_bi_trains_from_a_paired_store(tmp_path, data, caplog):
    opt = _opt(data, total_iter=2, ckpt_freq=0)
    opt["dataset"]["degradation"] = {"type": "BI"}
    train = opt["dataset"]["train"]
    del train["seq_dir"], train["crop_size"]
    train.update(gt_seq_dir=str(data / "BI_GT.rec"),
                 lr_seq_dir=str(data / "BI_LR.rec"), gt_crop_size=32)
    with caplog.at_level("INFO", logger="base"):
        model = _run(tmp_path / "bi", opt)
    assert model.state["step"] == 2
    lines = _log_lines(caplog)
    assert len(lines) == 2
    assert all(np.isfinite(float(kv.split(": ")[1])) for m in lines
               for kv in _LOG_LINE.match(m).group(5).split(", "))


def test_train_mode_needs_cuda_or_an_explicit_cpu(tmp_path, data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(tmp_path / "exp", _opt(data), gpu_ids="0")


@pytest.mark.parametrize("case", ["existing", "no_state"])
def test_train_torch_sh_refuses(tmp_path, case):
    """train_torch.sh refuses an existing train/ without a start_iter, and
    a start_iter with neither a train_iter{N}.yml nor a state_iter*.pth
    (train.sh looks for .npz states, which the port never writes)."""
    exp = tmp_path / "experiments_BD" / "FRVSR" / "X"
    os.makedirs(exp / "train" / "ckpt")
    (exp / "train" / "ckpt" / "state_iter4.npz").write_bytes(b"")
    args = ["BD", "FRVSR/X"] + ([] if case == "existing" else ["4"])
    res = subprocess.run(["bash", osp.join(_REPO, "train_torch.sh"), *args],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 1
    assert ("Please delete it" if case == "existing"
            else "refusing") in res.stdout
