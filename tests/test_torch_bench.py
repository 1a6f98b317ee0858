"""The port's measurement tools on the CPU: ``tools/bench_suite.py`` (its
perf canary with stubbed measurements, its FPS and train-step functions at
toy widths), ``tools/perf_canary.json``, ``tools/bench_step.py`` and the
root ``bench_torch.py``. The measurements themselves run on the card
(``chip_smoke.py``'s ``phase_bench``); here only their logic and their
inputs are held.

The train case's uint8 batch is held against ``scripts/bench_suite.py``'s
``build_train_case`` (loaded with importlib, as ``tests/test_perf_canary.py``
loads it), which draws it with numpy from seed 0.
"""

import importlib.util
import io
import json
import math
import os
import os.path as osp
import shutil
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from tecogan_tpu_torch.tools import bench_step, bench_suite
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# toy geometry: nf=8/nb=1, 3 frames of 16x24 LR; a 32^2 GT crop (8^2 LR)
_TOY_INFER = dict(nf=8, nb=1, frames=3, height=16, width=24)
_TOY_TRAIN = dict(nf=8, nb=1, batch=1, frames=3, gt_size=32)
_HEADLINE = ("infer_bf16_4x_bd_fps", "frvsr_train_ms", "tecogan_train_ms")


def _load_jax_suite():
    spec = importlib.util.spec_from_file_location(
        "bench_suite_jax", osp.join(REPO, "scripts", "bench_suite.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_canary_spec_is_well_formed():
    """The port's own canary: the three headline metrics, each with a
    positive baseline, one band in (0.25, 4) (the hosts' spread reaches
    0.50x and 2.07x of the baselines), the card's name and power limit,
    and at least 3 separate processes' readings inside its band."""
    with open(bench_suite._CANARY_PATH) as f:
        canary = json.load(f)
    assert "H100" in canary["card"]["name"]
    assert canary["card"]["power_limit"].endswith("W")
    metrics = {k: v for k, v in canary.items() if k in _HEADLINE}
    assert set(metrics) == set(_HEADLINE)
    for name, spec in metrics.items():
        assert spec["baseline"] > 0
        assert ("min_ratio" in spec) != ("max_ratio" in spec), name
        ratio = spec.get("min_ratio", spec.get("max_ratio"))
        assert 0.25 < ratio < 4.0, (name, ratio)
        runs = spec["runs"]
        assert len(runs) >= 3, name
        bound = spec["baseline"] * ratio
        assert all(r >= bound if "min_ratio" in spec else r <= bound
                   for r in runs), (name, runs, bound)


def _stub(monkeypatch, fps, fr_ms, tg_ms):
    monkeypatch.setattr(bench_suite, "_fps_infer", lambda *a, **k: fps)
    monkeypatch.setattr(
        bench_suite, "_train_iter",
        lambda model, **k: (fr_ms if model == "frvsr" else tg_ms) / 1000.0)


def test_canary_logic_detects_regressions(monkeypatch, capsys, tmp_path):
    """Stubbed measurements: inside the bands passes, outside fails;
    ``--update`` after a failed check leaves the file byte for byte, after
    a passing one writes the measured values."""
    path = str(tmp_path / "perf_canary.json")
    shutil.copy(bench_suite._CANARY_PATH, path)
    monkeypatch.setattr(bench_suite, "_CANARY_PATH", path)
    with open(path) as f:
        canary = json.load(f)
    fps, fr, tg = (canary[k]["baseline"] for k in _HEADLINE)
    floor = canary["infer_bf16_4x_bd_fps"]["min_ratio"]
    ceiling = canary["tecogan_train_ms"]["max_ratio"]

    _stub(monkeypatch, fps, fr, tg)
    assert bench_suite.check_canary(device="cpu") is True
    assert "PERF_CANARY PASS" in capsys.readouterr().out

    _stub(monkeypatch, fps * floor * 0.95, fr, tg)  # FPS below its floor
    assert bench_suite.check_canary(device="cpu") is False
    out = capsys.readouterr().out
    assert "REGRESSION" in out and "PERF_CANARY FAIL" in out

    _stub(monkeypatch, fps, fr, tg * ceiling * 1.05)  # past its ceiling
    assert bench_suite.check_canary(device="cpu") is False
    capsys.readouterr()

    with open(path, "rb") as f:
        before = f.read()
    assert bench_suite.main(["--check", "--update"], device="cpu") == 1
    with open(path, "rb") as f:
        assert f.read() == before
    assert "baselines left as they were" in capsys.readouterr().out

    _stub(monkeypatch, fps * 1.1, fr * 0.9, tg)
    assert bench_suite.main(["--check", "--update"], device="cpu") == 0
    with open(path) as f:
        updated = json.load(f)
    assert updated["infer_bf16_4x_bd_fps"]["baseline"] == round(fps * 1.1, 1)
    assert updated["frvsr_train_ms"]["baseline"] == round(fr * 0.9, 1)
    assert updated["card"] == canary["card"]


def test_update_needs_check():
    with pytest.raises(SystemExit):
        bench_suite.main(["--update"], device="cpu")


def test_headline_prints_one_json_line(monkeypatch, capsys):
    _stub(monkeypatch, 300.0, 100.0, 250.0)
    assert bench_suite.main(["--headline"], device="cpu") == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"infer_bf16_4x_bd_fps": 300.0,
                                "frvsr_train_ms": 100.0,
                                "tecogan_train_ms": 250.0}


@pytest.mark.parametrize("dtype,scale,deg", [
    ("bfloat16", 4, "BD"), ("float32", 4, "BD"), ("bfloat16", 2, "BI")])
def test_fps_infer_on_the_cpu(dtype, scale, deg):
    fps = bench_suite._fps_infer(dtype, scale=scale, degradation=deg,
                                 device="cpu", reps=1, **_TOY_INFER)
    assert math.isfinite(fps) and fps > 0


def test_fps_infer_batch_on_the_cpu():
    fps = bench_suite._fps_infer_batch(2, device="cpu", reps=1, chunk=2,
                                       **_TOY_INFER)
    assert math.isfinite(fps) and fps > 0


def test_no_card_raises():
    """Without a card and without an explicit CPU request the tools raise;
    they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_suite._fps_infer("bfloat16", **_TOY_INFER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_step.main(["frvsr"])


@pytest.mark.parametrize("deg", ["BD", "BI"])
def test_train_case_batch_is_the_jax_recipes(deg, monkeypatch):
    """The reference geometry's uint8 batch equals the JAX recipe's numpy
    draws from seed 0, BD (136^2 GT) and BI (128^2 GT + 32^2 LR); the
    recipe runs on a one-device mesh (its batch of 4 does not divide over
    the tests' 8 virtual devices)."""
    from tecogan_tpu import parallel

    mesh = parallel.get_mesh
    monkeypatch.setattr(parallel, "get_mesh", lambda: mesh(1))
    _, _, want, _ = _load_jax_suite().build_train_case("frvsr",
                                                       degradation=deg)
    for model in ("frvsr", "tecogan"):
        _, _, got = bench_suite.build_train_case(model, degradation=deg,
                                                 device="cpu")
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("model,mixed,deg,scale", [
    ("frvsr", True, "BD", 4), ("frvsr", False, "BI", 4),
    ("tecogan", True, "BD", 4), ("tecogan", True, "BI", 2)])
def test_train_iter_on_the_cpu(model, mixed, deg, scale):
    """One case and the pipelined timing at toy width: finite seconds and
    a FLOP rate; the step moved every generator weight."""
    step, state, batch = bench_suite.build_train_case(
        model, mixed_precision=mixed, degradation=deg, scale=scale,
        device="cpu", **_TOY_TRAIN)
    before = {k: v.clone() for k, v in state["g"].state_dict().items()}
    state, logs = step(state, batch)
    assert all(math.isfinite(float(v)) for v in logs.values())
    assert all(not torch.equal(before[k], v)
               for k, v in state["g"].state_dict().items())
    t, flops = bench_suite._train_iter(
        model, mixed_precision=mixed, report_mfu=True, degradation=deg,
        scale=scale, device="cpu", **_TOY_TRAIN)
    assert math.isfinite(t) and t > 0 and math.isfinite(flops) and flops > 0


def test_step_flops_counts_the_remat_recompute():
    """FlopCounterMode sees the forward that torch.utils.checkpoint runs
    again in the backward: a remat step counts more than one without."""
    flops = {}
    for remat in (True, False):
        step, state, batch = bench_suite.build_train_case(
            "frvsr", remat=remat, device="cpu", **_TOY_TRAIN)
        flops[remat] = bench_suite.step_flops(step, state, batch)
    assert flops[True] > flops[False] > 0


def test_loader_rate_on_the_host(tmp_path):
    rate = bench_suite._loader_rate(str(tmp_path), batch_size=2,
                                    num_workers=2, threads=1, seqs=3,
                                    frames=4, size=48, crop=32)
    assert math.isfinite(rate) and rate > 0


def test_bench_step_prints_ms(monkeypatch, capsys):
    """The CLI passes the model and the precision on; the suite's
    ``_train_iter`` (held above) is the measurement."""
    seen = []
    monkeypatch.setattr(bench_step, "_train_iter", lambda model, **k: (
        seen.append((model, k)), 0.0875)[1])
    assert bench_step.main(["frvsr", "--fp32"], device="cpu") == 0.0875
    assert seen == [("frvsr", {"mixed_precision": False, "device": "cpu"})]
    assert "frvsr fp32: 87.5 ms/iter on cpu" in capsys.readouterr().out


def _bench_torch():
    spec = importlib.util.spec_from_file_location(
        "bench_torch", osp.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_torch_prints_the_four_keys(monkeypatch):
    """The last line is one JSON object with exactly bench.py's four keys
    and the port's own metric name; the card line comes before it."""
    monkeypatch.setattr(bench_suite, "_fps_infer", lambda *a, **k: 540.0)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert _bench_torch().main(device="cpu") == 0
    lines = buf.getvalue().strip().splitlines()
    line = json.loads(lines[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line == {"metric": "torch_4x_bd_sr_fps_134x320", "value": 540.0,
                    "unit": "frames/sec", "vs_baseline": 20.0}
    assert lines[0] == "card: cpu"


def test_bench_torch_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, osp.join(REPO, "bench_torch.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=REPO)
    assert r.returncode == 2 and r.stdout == ""


def test_tools_import_without_jax_or_yaml():
    """The new tools and bench_torch.py import, and the suite measures at a
    toy width on the CPU, with jax, the JAX package and yaml blocked."""
    code = textwrap.dedent("""
        import importlib, sys
        for name in ("jax", "jaxlib", "tecogan_tpu", "yaml"):
            sys.modules[name] = None
        for m in ("bench_suite", "bench_step", "convert_checkpoint",
                  "resize_bd", "generate_lr_bi", "run_parity"):
            importlib.import_module("tecogan_tpu_torch.tools." + m)
        import bench_torch
        from tecogan_tpu_torch.tools import bench_suite
        fps = bench_suite._fps_infer("bfloat16", device="cpu", reps=1,
                                     nf=8, nb=1, frames=2, height=16,
                                     width=16)
        assert fps > 0
        assert not any(m in sys.modules and sys.modules[m] is not None
                       for m in ("jax", "tecogan_tpu", "yaml"))
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")
