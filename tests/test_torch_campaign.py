"""Port parity for the synthetic campaign
(``tecogan_tpu_torch/tools/run_synth_campaign.py``) against the JAX script
(``scripts/run_synth_campaign.py``, loaded with importlib), on the CPU:
the corpus bit for bit, the option dicts key for key, BI's LR and the
bicubic baseline within 1 gray level (float32 matmuls in another order),
the generated opt driving the port's loader, the harness line parser, one
end-to-end ``--smoke`` run; the scorer of ``docs/campaign_torch/
horizon.py`` (``TpuDefaultPrecision``: the TPU's DEFAULT-precision
products) and its ``stop_at`` and ``score`` helpers; and the committed
H100 runs (``docs/campaign_torch/``) consistent with their claims.

Measured shares of values 1 gray level apart (the rest equal) at the sizes
below: BI's LR records 0 of 11664 values and its ``test_LR`` tree 0 of
4608; the bicubic baseline 5 of 147456 (3.4e-5, BD) and 1 of 147456
(6.8e-6, BI). The tests hold them to 1 level on at most 1% of values.
"""

import importlib.util
import json
import os
import os.path as osp
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.data.records import RecordStore
from tecogan_tpu_torch.tools import run_synth_campaign as port
from tecogan_tpu_torch.utils.png import read_image
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DOCS = osp.join(REPO, "docs", "campaign_torch")
SMALL = dict(n_train=2, t_train=6, hw_train=(72, 72), n_test=1, t_test=6,
             hw_test=(64, 64))
# 1 gray level on at most this share of values (BI LR, bicubic baseline)
NEAR_FRAC = 0.01


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "run_synth_campaign_jax", osp.join(REPO, "scripts",
                                           "run_synth_campaign.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["run_synth_campaign_jax"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def geometry(jax_script):
    """Both modules' GEOM and PRECISION restored after the test."""
    saved = [(m, dict(m.GEOM), dict(m.PRECISION)) for m in (jax_script,
                                                              port)]
    yield
    for m, geom, prec in saved:
        m.GEOM.clear(), m.GEOM.update(geom)
        m.PRECISION.clear(), m.PRECISION.update(prec)


def _near(got, want):
    """(max |got - want|, share of values that differ) of uint8 arrays."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float(np.count_nonzero(d)) / d.size


def _tree(root):
    """{relative path: RGB pixels} of every PNG under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = osp.join(base, f)
            out[osp.relpath(p, root)] = read_image(p)
    return out


def _store_clips(rec_dir):
    store = RecordStore(rec_dir)
    with open(osp.join(rec_dir, "index.json")) as f:
        seqs = json.load(f)["seqs"]
    return {s["vid"]: np.stack([store.get(f"{s['vid']}_{s['t']}x{s['h']}x"
                                          f"{s['w']}_{i:04d}")
                                for i in range(s["t"])]) for s in seqs}


# ------------------------------------------------------------ the corpus

@pytest.mark.parametrize("seed", [0, 1])
def test_synth_clip_matches_jax(jax_script, seed):
    clip = port.synth_clip(np.random.default_rng(seed), t=6, h=64, w=80)
    want = jax_script.synth_clip(np.random.default_rng(seed), t=6, h=64,
                                 w=80)
    np.testing.assert_array_equal(clip, want)
    # test_synth_clip_shape_dtype_motion's properties
    assert clip.shape == (6, 64, 80, 3) and clip.dtype == np.uint8
    d01 = np.abs(clip[1].astype(np.int32) - clip[0].astype(np.int32)).mean()
    d05 = np.abs(clip[5].astype(np.int32) - clip[0].astype(np.int32)).mean()
    assert d01 > 0.5 and d05 > d01


def test_stage_data_matches_jax(jax_script, tmp_path):
    """BD: the GT records byte for byte (index and blob), the held-out
    PNGs pixel for pixel; a second call skips the records."""
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_script.stage_data(jwd, **SMALL)
    port.stage_data(pwd, **SMALL, device="cpu")
    for f in ("index.json", "data.bin"):
        with open(osp.join(jwd, "data", "GT.rec", f), "rb") as a, \
                open(osp.join(pwd, "data", "GT.rec", f), "rb") as b:
            assert a.read() == b.read(), f
    want, got = (_tree(osp.join(w, "data", "test_GT")) for w in (jwd, pwd))
    assert sorted(got) == sorted(want) == [f"held00/{i:04d}.png"
                                           for i in range(6)]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert not osp.exists(osp.join(pwd, "data", "LR.rec"))
    port.stage_data(pwd, **SMALL, device="cpu")  # done: skipped


def test_stage_data_bi_matches_jax(jax_script, tmp_path):
    """BI: GT records bit for bit, LR records and test_LR within 1 gray
    level of the JAX script's ``_bi_lr``; a BD-era workdir is refused."""
    jwd, pwd = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_script.stage_data(jwd, degradation="BI", **SMALL)
    port.stage_data(pwd, degradation="BI", **SMALL, device="cpu")
    want, got = (_store_clips(osp.join(w, "data", "GT.rec"))
                 for w in (jwd, pwd))
    assert sorted(got) == sorted(want) == ["clip000", "clip001"]
    for vid in want:
        np.testing.assert_array_equal(got[vid], want[vid])
    want, got = (_store_clips(osp.join(w, "data", "LR.rec"))
                 for w in (jwd, pwd))
    lr = np.stack([got[v] for v in sorted(got)])
    assert lr.shape == (2, 6, 18, 18, 3)
    diff, frac = _near(lr, np.stack([want[v] for v in sorted(want)]))
    assert diff <= 1 and frac <= NEAR_FRAC, (diff, frac)
    want, got = (_tree(osp.join(w, "data", "test_LR")) for w in (jwd, pwd))
    assert sorted(got) == sorted(want) and len(got) == 6
    diff, frac = _near(np.stack([got[k] for k in sorted(got)]),
                       np.stack([want[k] for k in sorted(want)]))
    assert diff <= 1 and frac <= NEAR_FRAC, (diff, frac)

    bd = str(tmp_path / "bd")
    port.stage_data(bd, **SMALL, device="cpu")
    with pytest.raises(SystemExit, match="without the paired BI half"):
        port.stage_data(bd, degradation="BI", **SMALL, device="cpu")


# ------------------------------------------------------------ the options

@pytest.mark.parametrize("degradation", ["BD", "BI"])
@pytest.mark.parametrize("scale", [4, 2])
@pytest.mark.parametrize("precision", ["mixed", "fp32"])
def test_option_dicts_match_jax(jax_script, geometry, monkeypatch,
                                degradation, scale, precision):
    """``_base_opt`` and the dicts the stages hand to the CLI (FRVSR,
    TecoGAN, test mode) equal the JAX script's key for key."""
    seen = {}
    for name, mod in (("jax", jax_script), ("port", port)):
        mod.GEOM["scale"] = scale
        mod.PRECISION["mixed"] = precision == "mixed"
        monkeypatch.setattr(
            mod, "_run_cli", lambda exp, opt, mode, *a, _n=name:
            seen.setdefault(_n, []).append((exp, mode, opt)))
    model = {"name": "FRVSR", "generator": {"name": "FRNet", "nf": 8}}
    train = {"generator": {"lr": 1e-4, "lr_schedule": {"type": "FixedLR"}}}
    args = ("/w", model, train, 40, 5, 10)
    assert port._base_opt(*args, crop=32, tempo=3,
                          degradation=degradation) == \
        jax_script._base_opt(*args, crop=32, tempo=3,
                             degradation=degradation)
    for name, mod in (("jax", jax_script), ("port", port)):
        kw = {"device": "cpu"} if mod is port else {}
        mod.stage_frvsr("/w", 4000, degradation=degradation, **kw)
        mod.stage_tecogan("/w", "/w/G.npz", 1000, degradation=degradation,
                          **kw)
        mod._test_model("/w", "FRVSR_x", "/w/G_iter4000.npz",
                        degradation=degradation, **kw)
    assert len(seen["port"]) == 3
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("degradation,shapes", [
    ("BD", {"gt": (4, 3, 40, 40, 3)}),
    ("BI", {"gt": (4, 3, 32, 32, 3), "lr": (4, 3, 8, 8, 3)})])
def test_campaign_config_feeds_port_loader(tmp_path, degradation, shapes):
    """The generated opt drives the port's loader factory (its recipe is
    device-resident, so the loader is given the CPU): BD's enlarged crop
    32 + 2 * int(3 * 1.5); BI's pairs locked to gt_crop / scale."""
    from tecogan_tpu_torch.data import create_dataloader

    wd = str(tmp_path)
    port.stage_data(wd, degradation=degradation, **SMALL, device="cpu")
    model = {"name": "FRVSR", "generator": {"name": "FRNet", "nf": 8,
                                            "nb": 2}}
    train = {"generator": {"lr": 1e-4, "lr_schedule": {"type": "FixedLR"}}}
    opt = port._base_opt(wd, model, train, total_iter=2, test_freq=2,
                         ckpt_freq=2, crop=32, tempo=3,
                         degradation=degradation)
    loader = create_dataloader(opt, "train", "train",
                               device=torch.device("cpu"))
    batch = next(iter(loader))
    assert {k: tuple(batch[k].shape) for k in shapes} == shapes
    assert all(batch[k].dtype == torch.uint8 for k in shapes)


# ------------------------------------------------------------ evaluation

@pytest.mark.parametrize("degradation", ["BD", "BI"])
def test_bicubic_baseline_matches_jax(jax_script, geometry, tmp_path,
                                      degradation):
    wd = str(tmp_path)
    kw = dict(n_train=1, t_train=4, hw_train=(48, 48), n_test=2, t_test=4,
              hw_test=(64, 96))
    port.stage_data(wd, degradation=degradation, **kw, device="cpu")
    jroot = jax_script._bicubic_baseline(wd, degradation=degradation)
    os.rename(jroot, jroot + "_jax")
    root = port._bicubic_baseline(wd, degradation=degradation, device="cpu")
    want, got = _tree(jroot + "_jax"), _tree(root)
    assert sorted(got) == sorted(want) and len(got) == 8
    diff, frac = _near(np.stack([got[k] for k in sorted(got)]),
                       np.stack([want[k] for k in sorted(want)]))
    assert got[sorted(got)[0]].shape == (64, 96, 3)
    assert diff <= 1 and frac <= NEAR_FRAC, (diff, frac)


def test_metric_line_re_parses_the_port_harness(tmp_path, rng, capsys):
    """The parser reads the port harness's own summary lines (run on a
    6-frame sequence), and a 'nan' average in that format."""
    from tecogan_tpu_torch.official_metrics import metrics
    from tecogan_tpu_torch.utils.png import write_png

    for d in ("gt", "sr"):
        os.makedirs(tmp_path / d / "s")
        for i in range(6):
            img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
            write_png(str(tmp_path / d / "s" / f"{i:04d}.png"), img)
    metrics.evaluate_folders([str(tmp_path / "sr")], [str(tmp_path / "gt")],
                             str(tmp_path / "out"), device="cpu")
    lines = [port.METRIC_LINE_RE.match(ln.strip())
             for ln in capsys.readouterr().out.splitlines()]
    got = {m.group(1): int(m.group(2)) for m in lines if m}
    assert got == {"PSNR": 2, "SSIM": 2, "tOF": 1}
    m = port.METRIC_LINE_RE.match(
        f"tOF, total frame 100, total avg {float('nan'):02.4f}, "
        f"folder avg {float('nan'):02.4f}")
    assert m and m.group(3) == m.group(4) == "nan"
    assert port.METRIC_LINE_RE.match(
        "PSNR, total frame 104, total avg 27:06;13, folder avg 1") is None


def test_smoke_campaign_end_to_end(tmp_path):
    """All four stages through the CLIs on the CPU: summary.json with the
    three rows and the harness's frame counts, 2 x (10 - 4) and
    2 x (10 - 5) for tOF; the artifacts of every stage."""
    wd = str(tmp_path / "wd")
    port.main(["--smoke", "--workdir", wd], device="cpu")
    with open(osp.join(wd, "eval", "summary.json")) as f:
        summary = json.load(f)
    assert sorted(summary) == ["FRVSR_Synth_4xSR", "TecoGAN_Synth_4xSR",
                               "bicubic"]
    for row in summary.values():
        assert {k: v["frames"] for k, v in row.items()} == {
            "PSNR": 12, "SSIM": 12, "tOF": 10}
        assert all(np.isfinite(v["frame_avg"]) for v in row.values())
    for path in ("FRVSR_Synth_4xSR/train/ckpt/G_iter6.npz",
                 "TecoGAN_Synth_4xSR/train/ckpt/G_iter4.npz",
                 "TecoGAN_Synth_4xSR/train/ckpt/D_iter4.npz",
                 "FRVSR_Synth_4xSR/train.yml", "FRVSR_Synth_4xSR/train.log",
                 "eval/FRVSR_Synth_4xSR/test.log"):
        assert osp.exists(osp.join(wd, path)), path
    with open(osp.join(wd, "FRVSR_Synth_4xSR", "train.yml")) as f:
        assert "--gpu_ids" not in f.read()
    with open(osp.join(wd, "FRVSR_Synth_4xSR", "train.log")) as f:
        assert "kernel launches: " in f.read()


def test_failed_cli_raises_with_its_log(tmp_path):
    """A CLI that exits non-zero raises with the end of its log (the
    traceback), which the log file alone would keep."""
    exp = str(tmp_path / "exp")
    with pytest.raises(RuntimeError, match="exited with") as err:
        port._run_cli(exp, {"model": {"name": "FRVSR"}}, "train",
                      device="cpu")
    assert "Traceback" in str(err.value)
    with open(osp.join(exp, "train.log")) as f:
        assert f.read()[-200:] in str(err.value)


def test_kernel_launch_counts_reset():
    """``reset_kernel_launches`` zeroes every count the CLI logs."""
    from tecogan_tpu_torch import ops
    from tecogan_tpu_torch.ops import dcn, warp_cuda, warp_phases, warp_vjp

    for fn in (warp_cuda.warp_planes, warp_cuda.warp_planes_window,
               warp_cuda.warp_rgb, warp_vjp.warp_dimage, warp_vjp.warp_dflow,
               warp_phases.warp_phases, warp_cuda.warp_zero,
               dcn.dcn_columns):
        fn.launches += 3
    warp_cuda.warp_planes.band_launches += 2
    warp_vjp.warp_dimage.dflow_launches += 1
    assert all(ops.kernel_launches().values())
    ops.reset_kernel_launches()
    assert ops.kernel_launches() == dict.fromkeys(
        ("K1", "K1 band", "K1 window", "K2", "K3", "K3+K4", "K4", "K5",
         "K1 zero", "DCN"), 0)


def test_imports_without_jax_cv2_yaml_and_needs_a_card(tmp_path):
    """The tool imports with jax, the JAX package, cv2 and yaml blocked;
    without a card and without device="cpu" it raises before any stage
    writes anything."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "tecogan_tpu", "cv2", "yaml"):
            sys.modules[name] = None
        import torch
        from tecogan_tpu_torch.tools import run_synth_campaign as r
        assert not torch.cuda.is_available()
        try:
            r.main(["data", "--workdir", {str(tmp_path / "wd")!r}])
        except RuntimeError as e:
            assert "no CUDA device" in str(e), e
        else:
            raise AssertionError("ran without a card")
        try:
            r.stage_data({str(tmp_path / "wd2")!r}, degradation="BI",
                         n_train=1, t_train=2, hw_train=(8, 8), n_test=0)
        except ImportError:
            pass  # cv2, blocked, is the synthesis's alone
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert not osp.exists(tmp_path / "wd")
    assert not osp.exists(tmp_path / "wd2" / "data" / "GT.rec" / "index.json")
    assert port.DEFAULT_WORKDIR.startswith(osp.join(REPO, "build"))


# ------------------------------------------------------------ the monitor

def test_monitor_reads_the_port_logs(tmp_path, rng):
    """``scripts/monitor_training.py`` parses a train.log written by the
    port's ``format_train_msg`` and a validation JSON written by its
    ``MetricCalculator``, and plots them."""
    from tecogan_tpu_torch.metrics.metric_calculator import MetricCalculator
    from tecogan_tpu_torch.utils.logging_utils import format_train_msg

    exp = tmp_path / "experiments_BD" / "FRVSR" / "Exp"
    os.makedirs(exp / "train")
    with open(exp / "train" / "train.log", "w") as f:
        for i, it in enumerate(range(100, 400, 100)):
            msg = format_train_msg(i, it, {"lr_G": 1e-4},
                                   {"l_pix_G": 0.1 / (i + 1),
                                    "l_warp_G": -0.5})
            f.write(f"2026-10-17 12:00:0{i},000 [INFO]: {msg}\n")
    calc = MetricCalculator({"metric": {"PSNR": {"colorspace": "y"},
                                        "SSIM": None}, "device_ids": []})
    json_path = str(exp / "test" / "metrics" / "Vid4_avg.json")
    for it in (500, 1000):
        calc.reset()
        gt = (rng.random((3, 32, 32, 3)) * 255).astype(np.uint8)
        calc.compute_sequence_metrics("s", gt, np.clip(gt + 1, 0, 255))
        calc.save(f"G_iter{it}", json_path)
    sys.path.insert(0, osp.join(REPO, "scripts"))
    try:
        import monitor_training as mt
    finally:
        sys.path.pop(0)
    series = mt.parse_log(str(exp / "train" / "train.log"))
    assert [it for it, _ in series["l_pix_G"]] == [100, 200, 300]
    assert series["l_warp_G"][0][1] == -0.5
    mets = mt.parse_metrics_json(json_path)
    assert [it for it, _ in mets["PSNR"]] == [500, 1000]
    r = subprocess.run([sys.executable,
                        osp.join(REPO, "scripts", "monitor_training.py"),
                        "-m", "FRVSR", "-d", "BD", "-e", "Exp"],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert (exp / "monitor.png").exists()


# ------------------------------------------------------------ the H100 run

# ------------------------------------------- the TPU-precision scorer

@pytest.fixture(scope="module")
def horizon():
    """``docs/campaign_torch/horizon.py``, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "campaign_horizon", osp.join(DOCS, "horizon.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_f64(x):
    return x.to(torch.bfloat16).double()


_PRODUCTS = {
    "conv2d": (((2, 5, 9, 11), (7, 5, 3, 3), (7,)),
               lambda x, w, b: torch.nn.functional.conv2d(x, w, b,
                                                          padding=1)),
    "conv_transpose2d": (((2, 5, 9, 11), (5, 6, 4, 4), (6,)),
                         lambda x, w, b: torch.nn.functional.
                         conv_transpose2d(x, w, b, stride=2, padding=1)),
    "matmul": (((3, 40, 33), (33, 21)), lambda a, b: a @ b),
    "einsum": (((40, 33), (3, 33, 21)),
               lambda a, b: torch.einsum("Oh,...hw->...Ow", a, b)),
    "linear": (((6, 33), (21, 33), (21,)), torch.nn.functional.linear),
    "bmm": (((3, 40, 33), (3, 33, 21)), torch.bmm),
}


@pytest.mark.parametrize("op", sorted(_PRODUCTS))
def test_tpu_default_products_round_both_operands(horizon, rng, op):
    """Under the mode a product of float32 operands equals the float64
    product of their bf16 roundings (a bias unrounded) to 1e-6 relative,
    and differs from the float32 product; after the mode the same call is
    the float32 product again, bit for bit, and TF32's setting is as it
    was."""
    shapes, fn = _PRODUCTS[op]
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    plain = fn(*args)
    want = fn(*[_bf16_f64(a) for a in args[:2]],
              *[a.double() for a in args[2:]])
    tf32 = torch.backends.cudnn.allow_tf32
    mode = horizon.TpuDefaultPrecision()
    with mode:
        got = fn(*args)
    assert got.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= 1e-6 * scale
    assert float((plain - got).abs().max()) > 1e-4 * scale
    assert sum(mode.rounded.values()) == 1
    assert torch.equal(fn(*args), plain)
    assert torch.backends.cudnn.allow_tf32 == tf32


@pytest.mark.parametrize("warp", ["warp_planes", "warp_rgb"])
def test_tpu_default_leaves_the_warp_unchanged(horizon, rng, warp):
    """The port's warps (their plain versions on the CPU) pass the mode
    bit for bit, and the mode rounds nothing in them: the Pallas warps
    computed in float32 on the TPU's vector unit, not its MXU."""
    from tecogan_tpu_torch.ops import warp_cuda

    fn = getattr(warp_cuda, warp)
    img = torch.from_numpy(rng.random((2, 3, 24, 20)).astype(np.float32))
    flow = torch.from_numpy(
        (rng.standard_normal((2, 24, 20, 2)) * 3).astype(np.float32))
    if warp == "warp_rgb":
        # the training forward's NHWC layout
        img = img.contiguous(memory_format=torch.channels_last)
    plain = fn(img, flow)
    mode = horizon.TpuDefaultPrecision()
    with mode:
        got = fn(img, flow)
    assert torch.equal(got, plain)
    assert not mode.rounded and mode.passed


def test_stop_at_and_score_read_the_validation(horizon, tmp_path):
    """``stop_at`` stops a run once its validation JSON holds the asked
    checkpoint, with only the save cadence set; ``score``'s fp32 reading
    of that checkpoint is the validation's own, its TpuDefaultPrecision
    reading another, and in one FRNet forward the mode rounds the
    convolutions and resize products and passes the warp."""
    wd = str(tmp_path / "wd")
    port.main(["data", "--smoke", "--workdir", wd], device="cpu")
    rc = horizon.stop_at(1, ["frvsr", "--smoke", "--workdir", wd],
                         ckpt_freq=1, device="cpu", poll_s=0.1)
    assert rc == 0
    exp = osp.join(wd, "FRVSR_Synth_4xSR")
    with open(osp.join(exp, "test", "metrics",
                       "SynthHeldout_avg.json")) as f:
        val = json.load(f)
    assert "G_iter1" in val and "G_iter6" not in val
    ckpt = osp.join(exp, "train", "ckpt", "G_iter1.npz")
    out = str(tmp_path / "score.json")
    horizon.score(wd, ckpt, out, device="cpu", nf=8, nb=2)
    with open(out) as f:
        res = json.load(f)
    assert res["fp32"] == val["G_iter1"]
    assert res["tpu_default"] != res["fp32"]
    assert abs(float(res["tpu_default"]["PSNR"])
               - float(res["fp32"]["PSNR"])) < 1.0
    ops = res["ops_in_one_frnet_forward"]
    assert set(ops["rounded"]) == {"conv2d", "conv_transpose2d", "matmul"}
    assert "warp_planes.default" in ops["passed"]


def test_full_schedule_rehearsal(horizon, jax_script, tmp_path,
                                 monkeypatch):
    """``run_full.sh``'s steps on the CPU at toy width: a FRVSR run of the
    6-iteration smoke recipe (milestones 2 and 4) stopped once G_iter3 is
    validated, carried (the state and every G but the one the state
    holds) and restored into a fresh workdir with a remade corpus (every
    G kept apart, the state's remade bit for bit), resumed there to its
    end across the
    milestone at 4 (``lr_G`` on every line the JAX schedule's, the first
    line after the resume included), the stopped CLI's log ending in its
    launch line; then the scorer's point reading and
    the held-out rows plain and under the scorer through the official
    harness."""
    from tecogan_tpu.models.schedules import multistep_lr

    base_opt = port._base_opt

    def every_line(*a, **kw):
        opt = base_opt(*a, **kw)
        opt["logger"]["log_freq"] = 1
        return opt

    monkeypatch.setattr(port, "_base_opt", every_line)
    run = ["frvsr", "--smoke", "--workdir"]
    wd, wd2, out = (str(tmp_path / d) for d in ("call1", "call2", "carry"))
    port.main(["data", "--smoke", "--workdir", wd], device="cpu")
    assert horizon.stop_at(3, run + [wd], ckpt_freq=1, device="cpu",
                           poll_s=0.02) == 0
    # the SIGINT-stopped CLI logs its launches on the way out, after the
    # emergency save (or its refusal inside a step): no kernel on the CPU
    log = osp.join(wd, "FRVSR_Synth_4xSR", "train.log")
    with open(log) as f:
        text = f.read()
    assert 0 <= text.rfind("Emergency") < text.rfind("kernel launches: ")
    _, _, stopped = horizon.read_log(log)
    assert len(stopped) == 1 and not any(stopped[0].values()), stopped
    horizon.carry(wd, out, state="FRVSR", ckpts="FRVSR")
    ckpt = osp.join("FRVSR_Synth_4xSR", "train", "ckpt")
    carried = sorted(os.listdir(osp.join(out, ckpt)))
    n = int(carried[-1][len("state_iter"):-len(".pth")])
    assert carried == [f"G_iter{i}.npz" for i in range(1, n)] + [
        f"state_iter{n}.pth"]
    port.main(["data", "--smoke", "--workdir", wd2], device="cpu")
    kept = str(tmp_path / "ckpts")
    horizon.restore(out, wd2, kept, nb=2)
    assert sorted(os.listdir(osp.join(wd2, ckpt))) == [f"state_iter{n}.pth"]
    for i in range(1, n + 1):
        with np.load(osp.join(kept, "FRVSR_Synth_4xSR", f"G_iter{i}.npz")) \
                as a, np.load(osp.join(wd, ckpt, f"G_iter{i}.npz")) as b:
            assert a.files == b.files
            assert all(np.array_equal(a[k], b[k]) for k in a.files), i
    assert horizon.stop_at(0, run + [wd2], ckpt_freq=1, device="cpu",
                           budget=1e6) == 0
    lines, resumes, launches = horizon.read_log(
        osp.join(wd2, "FRVSR_Synth_4xSR", "train.log"))
    schedule = multistep_lr(1e-4, [2, 4], 0.5)
    assert resumes == [[n, n + 1]] and lines[-1]["iter"] == 6
    assert {r["iter"] for r in lines} == set(range(1, 7))
    for r in lines:
        assert r["lr_G"] == pytest.approx(float(schedule(r["iter"])),
                                          rel=1e-6), r
    assert launches and set(launches[-1]) >= {"K2", "K3", "K4"}

    with open(osp.join(wd2, "FRVSR_Synth_4xSR", "test", "metrics",
                       "SynthHeldout_avg.json")) as f:
        val = json.load(f)
    assert sorted(val, key=horizon._iter_of) == [
        f"G_iter{i}" for i in range(1, 7)]
    last = str(tmp_path / "last")
    os.makedirs(last)
    os.link(osp.join(wd2, ckpt, "G_iter6.npz"), osp.join(last, "G_iter6.npz"))
    scores = str(tmp_path / "scores.json")
    horizon.score_points(wd2, last, scores, nf=8, nb=2)
    with open(scores) as f:
        row = json.load(f)["G_iter6"]
    assert set(row) == {"tpu_default", "seconds"}
    assert row["tpu_default"] != val["G_iter6"]

    held = str(tmp_path / "heldout.json")
    g6 = osp.join(last, "G_iter6.npz")
    horizon.heldout_tpu(wd2, g6, g6, held, nf=8, nb=2)
    with open(held) as f:
        rows = json.load(f)
    assert set(rows) == {f"{r}_{t}" for r in ("FRVSR_Synth_4xSR",
                                              "TecoGAN_Synth_4xSR")
                         for t in ("plain", "tpu_default")}
    for tag in ("plain", "tpu_default"):
        got = rows[f"FRVSR_Synth_4xSR_{tag}"]
        assert got == rows[f"TecoGAN_Synth_4xSR_{tag}"]
        assert all(np.isfinite(got[m]["frame_avg"])
                   for m in ("PSNR", "SSIM", "tOF"))
    assert rows["FRVSR_Synth_4xSR_plain"] != rows[
        "FRVSR_Synth_4xSR_tpu_default"]


def test_h100_campaign_artifacts_consistent(horizon):
    """The committed H100 runs agree with their claims. The horizon run
    (FRVSR 4000 iterations, TecoGAN +1000, eval): the validation curve
    improves over the schedule and does not collapse late, both models
    beat bicubic, and the README names the card and its power limit. The
    FRVSR legs: every validation value finite, each curve rising,
    each leg's summary naming the JAX run's reading at its checkpoint,
    its own reading the leg's validation, its band verdict the numbers';
    the bicubic baseline under the scorer against the JAX row."""
    with open(osp.join(DOCS, "frvsr_validation.json")) as f:
        d = json.load(f)
    iters = sorted(int(k[len("G_iter"):]) for k in d)
    assert iters == list(range(500, 4001, 500))
    curve = [{m: float(v) for m, v in d[f"G_iter{i}"].items()}
             for i in iters]
    psnr = [pt["PSNR"] for pt in curve]
    tof = [pt["tOF"] for pt in curve]
    assert psnr[-1] > psnr[0] + 2.0, psnr
    assert all(v > psnr[0] for v in psnr[4:]), psnr
    assert tof[-1] < 0.6 * tof[0], tof
    with open(osp.join(DOCS, "tecogan_validation.json")) as f:
        assert json.load(f)
    with open(osp.join(DOCS, "summary.json")) as f:
        summary = json.load(f)
    bic = summary["bicubic"]
    for row in ("FRVSR_Synth_4xSR", "TecoGAN_Synth_4xSR"):
        got = summary[row]
        assert got["PSNR"]["frame_avg"] > bic["PSNR"]["frame_avg"], row
        assert got["SSIM"]["frame_avg"] > bic["SSIM"]["frame_avg"], row
        assert got["tOF"]["frame_avg"] < bic["tOF"]["frame_avg"], row
    with open(osp.join(DOCS, "README.md")) as f:
        readme = f.read()
    assert "NVIDIA H100" in readme and " W" in readme
    with open(osp.join(DOCS, "legs_summary.json")) as f:
        legs = json.load(f)
    assert set(legs) == set(horizon.LEGS)
    for leg, row in legs.items():
        jax_json, val_every = horizon.LEGS[leg]
        with open(osp.join(DOCS, f"{leg}_validation.json")) as f:
            val = {k: {m: float(v) for m, v in pt.items()}
                   for k, pt in json.load(f).items()}
        iters = sorted(int(k[len("G_iter"):]) for k in val)
        n = int(row["checkpoint"][len("G_iter"):])
        assert iters == list(range(val_every, n + 1, val_every)), leg
        assert all(np.isfinite(v) for pt in val.values()
                   for v in pt.values()), leg
        psnr = [val[f"G_iter{i}"]["PSNR"] for i in iters]
        assert all(b > a for a, b in zip(psnr, psnr[1:])), (leg, psnr)
        assert row["own_fp32"] == val[row["checkpoint"]], leg
        with open(osp.join(REPO, "docs", "campaign", jax_json)) as f:
            jax = {m: float(v)
                   for m, v in json.load(f)[row["checkpoint"]].items()}
        assert row["jax"] == jax, leg
        emu = row["tpu_default"]
        assert row["tpu_default_within_band_of_jax"] == (
            abs(emu["PSNR"] - jax["PSNR"]) <= 0.5
            and abs(emu["SSIM"] - jax["SSIM"]) <= 1e-3
            and abs(emu["tOF"] - jax["tOF"]) <= 0.1 * jax["tOF"]), leg
    with open(osp.join(DOCS, "bicubic_tpu_default.json")) as f:
        bic = json.load(f)
    for m in ("PSNR", "SSIM", "tOF"):
        assert (bic["port_cpu_tpu_default"][m]["frame_avg"]
                == bic["jax_tpu"][m]["frame_avg"]), m
    # BI's comparison of record: (c'), its LR frames made as the JAX leg's
    assert [leg for leg, row in legs.items() if not row["of_record"]] == [
        "frvsr_bi"]
    assert legs["frvsr_bi"]["superseded_by"] == "frvsr_bi_tpu_lr"
    assert not legs["frvsr_bi"]["tpu_default_within_band_of_jax"]
    assert legs["frvsr_bi_tpu_lr"]["tpu_default_within_band_of_jax"]
    _full_schedule_consistent(horizon)


def _full_schedule_consistent(horizon):
    """The full 4x BD schedule (FRVSR to 40000, TecoGAN after it, the
    eval): every JAX point the run reached scored, finite, its own
    reading the run's validation, its verdicts the numbers'; FRVSR all
    eight; FRVSR@40k above FRVSR@5000 and both models above bicubic;
    ``lr_G`` the JAX schedule's on every logged line, the first after each
    resume included; each half crossed a resume and logged every 100th
    iteration; TecoGAN warm-started from the run's G_iter40000; a run that
    ended by itself logged its kernel launches as its iterations times
    the step's structure."""
    from tecogan_tpu.models.schedules import multistep_lr

    with open(osp.join(DOCS, "full_summary.json")) as f:
        full = json.load(f)
    band = horizon.BAND
    assert full["band"] == band

    def verdict(got, jax):
        return (abs(got["PSNR"] - jax["PSNR"]) <= band["PSNR"]
                and abs(got["SSIM"] - jax["SSIM"]) <= band["SSIM"]
                and abs(got["tOF"] - jax["tOF"]) <= band["tOF"] * jax["tOF"])

    schedules = {"frvsr": multistep_lr(1e-4, [16000, 32000], 0.5),
                 "tecogan": lambda i: 5e-5}
    per_iter = {"frvsr": {"K2": 21, "K3": 9, "K3+K4": 9, "K4": 1},
                "tecogan": {"K2": 41, "K3": 19, "K3+K4": 18, "K4": 1}}
    for half, (every, total, jax_json) in horizon.FULL.items():
        row = full[half]
        with open(osp.join(REPO, "docs", "campaign", jax_json)) as f:
            jax = {k: {m: float(v) for m, v in pt.items()}
                   for k, pt in json.load(f).items()}
        with open(osp.join(DOCS, f"full_{half}_validation.json")) as f:
            val = {k: {m: float(v) for m, v in pt.items()}
                   for k, pt in json.load(f).items()}
        last = horizon._iter_of(row["last_validated"])
        reached = [f"G_iter{i}" for i in range(every, last + 1, every)]
        assert sorted(val, key=horizon._iter_of) == reached, half
        assert set(row["points"]) == set(jax), half
        if half == "frvsr":
            assert last == total
        for key, pt in row["points"].items():
            assert pt["jax"] == jax[key] and pt["reached"] == (key in val)
            if key not in val:
                assert set(pt) == {"jax", "reached"}, key
                continue
            assert pt["own_fp32"] == val[key]
            assert all(np.isfinite(v) for r in ("own_fp32", "tpu_default")
                       for v in pt[r].values()), (half, key)
            assert pt["tpu_default_within_band_of_jax"] == verdict(
                pt["tpu_default"], jax[key]), (half, key)
            assert pt["tpu_default_minus_jax"] == pytest.approx(
                {m: pt["tpu_default"][m] - jax[key][m]
                 for m in ("PSNR", "SSIM", "tOF")}, abs=1e-6)
        lines, resumes, launches = horizon.read_log(
            osp.join(DOCS, f"full_{half}_train.log"))
        first = {}
        for r in lines:
            first.setdefault(r["iter"], r)
            assert r["lr_G"] == pytest.approx(float(schedules[half](
                r["iter"])), rel=1e-3), (half, r["iter"])
            if half == "tecogan":
                assert r["lr_D"] == pytest.approx(5e-5, rel=1e-3)
        assert sorted(first) == list(range(100, max(first) + 1, 100)), half
        assert max(first) >= last
        assert resumes and all(b == a + 100 and a % every == 0
                               for a, b in resumes), (half, resumes)
        assert row["resumes"] == resumes
        if max(first) == total:
            resumed = resumes[-1][0]
            want = {k: v * (total - resumed)
                    for k, v in per_iter[half].items()}
            got = launches[-1]
            assert {k: got[k] for k in want} == want, (half, got)
            assert got["K1"] == 144 * (total // every - resumed // every)
    own = {k: v["own_fp32"] for k, v in full["frvsr"]["points"].items()}
    assert own["G_iter40000"]["PSNR"] > own["G_iter5000"]["PSNR"]
    assert own["G_iter40000"]["tOF"] < own["G_iter5000"]["tOF"]
    with open(osp.join(DOCS, "full_tecogan_train.log")) as f:
        assert re.search(r"load_path: \S*FRVSR_Synth_4xSR/train/ckpt/"
                         r"G_iter40000\.npz", f.read())
    with open(osp.join(DOCS, "full_eval_summary.json")) as f:
        ev = json.load(f)
    bic = ev["bicubic"]
    for name in ("FRVSR_Synth_4xSR", "TecoGAN_Synth_4xSR"):
        assert ev[name]["PSNR"]["frames"] == 104
        assert ev[name]["PSNR"]["frame_avg"] > bic["PSNR"]["frame_avg"]
        assert ev[name]["tOF"]["frame_avg"] < bic["tOF"]["frame_avg"]
    held = full["heldout"]
    assert held["FRVSR_Synth_4xSR"]["checkpoint"] == "G_iter40000"
    assert held["TecoGAN_Synth_4xSR"]["checkpoint"] == full["tecogan"][
        "last_validated"]
    for name, row in held.items():
        assert row["own_card"] == {m: ev[name][m]["frame_avg"]
                                   for m in ("PSNR", "SSIM", "tOF")}, name
        assert row["tpu_default_within_band_of_jax"] == (
            verdict(row["tpu_default_cpu"], row["jax"])
            if row["checkpoint"] == row["jax_checkpoint"] else None), name
