"""The harness on the CPU: the registry finds cells, configurations and
metrics added as files; each driver's run prints a last line with the
result's keys; the command refuses to run without a card; nothing under
``vsrbench/`` imports JAX or the JAX package, and the reference imports
nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from vsrbench import harness
from vsrbench.tests import toy

REPO = toy.REPO
PKG = toy.HERE
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _run_toy(root, cell, trace, fault=None):
    args = [sys.executable, "-m", "vsrbench.tests.toy", str(root), cell,
            str(trace)] + ([fault] if fault else [])
    return subprocess.run(args, cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=600)


def test_registry_finds_a_cell_a_config_and_a_metric_added_as_files(
        tmp_path):
    root = toy.make_root(str(tmp_path))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    # a new configuration, traffic mix, cell and metric: files and entries
    cfg_path = os.path.join(root, "configs", "frvsr_4x_bd_nb5.json")
    with open(os.path.join(root, "configs", "frvsr_4x_bd.json")) as f:
        cfg = json.load(f)
    cfg["generator"]["nb"] = 2
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "traffic", "infer_s4.json")) as f:
        mix = json.load(f)
    mix["streams"] = 1
    with open(os.path.join(root, "traffic", "infer_s1.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "limits", "nb5.infer_s1.json"), "w") as f:
        json.dump({"checks": {"frame_mad_worst": 50.0}}, f)
    with open(os.path.join(root, "metrics", "calls.infer.py"), "w") as f:
        f.write("def read(rec):\n"
                "    return len(rec['dispatch_s']) if rec.get('kind') == "
                "'infer' else None\n")
    # a metric of the record every traced run carries: the program's
    # launch counters and the memory peak over the traced sub-window
    with open(os.path.join(root, "metrics", "counters.infer.py"), "w") as f:
        f.write("def read(rec):\n"
                "    if 'launches' not in rec:\n"
                "        return None\n"
                "    return len(rec['launches']) + rec['memory_peak_bytes']\n")
    bench["configs"].append({"name": "nb5", "source": "x", "file": cfg_path,
                             "reduced": ["nb"], "why": "test"})
    bench["workloads"].append({"name": "nb5.infer_s1", "config": "nb5",
                               "traffic": "infer_s1", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("nb5.infer_s1")
    bench["per_layer"].append({"name": "calls.infer", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "streaming loop", "moves": "infer_fps",
                               "workloads": ["nb5.infer_s1"]})
    bench["per_layer"].append({"name": "counters.infer", "unit": "counters",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "kernels", "moves": "infer_fps",
                               "workloads": ["nb5.infer_s1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = harness.find_cell(bench, "nb5.infer_s1", root)
    assert cell["config_data"]["generator"]["nb"] == 2
    assert cell["mix"]["streams"] == 1
    assert cell["limits"]["checks"] == {"frame_mad_worst": 50.0}
    assert [m["name"] for m in cell["end_to_end"]] == ["infer_fps",
                                                       "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["calls.infer",
                                                      "counters.infer"]
    got = harness.read_metrics(cell["per_layer"],
                               {"kind": "infer", "dispatch_s": [1, 2, 3]},
                               root)
    assert got == {"calls.infer": {"value": 3.0, "unit": "calls"}}
    assert harness.read_metrics(cell["per_layer"], {"kind": "train"},
                                root) == {}

    # and the new cell runs end to end on the new files
    res = _run_toy(root, "nb5.infer_s1", 1)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["metrics"]["calls.infer"]["value"] == 1.0
    # every counter of ``tecogan_tpu_torch.ops.kernel_launches``; no
    # device memory on the CPU
    assert line["metrics"]["counters.infer"]["value"] == 8.0


@pytest.mark.parametrize("cell,trace", [
    ("frvsr_4x_bd.infer_s4", 0), ("frvsr_4x_bd.infer_s4", 1),
    ("tecogan_4x_bd.train_b64", 0), ("tecogan_4x_bd.train_b64", 1),
    ("frvsr_4x_bd.train_b512", 0), ("frvsr_4x_bd.train_b512", 1)])
def test_each_driver_prints_the_result_line(tmp_path, cell, trace):
    root = toy.make_root(str(tmp_path), {
        "frvsr_4x_bd.infer_s4": {"frame_mad_worst": 1e9},
        "tecogan_4x_bd.train_b64": {"loss_gap": 1e9, "grad_gap": 1e9},
        "frvsr_4x_bd.train_b512": {"loss_gap": 1e9, "grad_gap": 1e9}})
    res = _run_toy(root, cell, trace)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == list(KEYS)
    assert keys[-1] == "checks"
    assert set(keys) == set(KEYS) | {"checks"} | (
        {"breakdown"} if trace else set())
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["count"] == 1
    names = set(line["metrics"])
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
        # the host-clock readers find their spans on the CPU; the device
        # readers find no device time there and report nothing
        assert names == ({"dispatch_ms.infer"} if "infer" in cell else
                         {"dispatch_ms.train", "batch_wait_ms.train"})
    else:
        rate = "infer_fps" if "infer" in cell else "train_clips_per_s"
        assert names == {rate, "setup_s"}
    # the compared numbers, each beside its limit, end standard error
    err = res.stderr.strip().splitlines()
    checks = line["checks"]
    assert err[-len(checks):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}"
        for k, v in checks.items()]


def test_the_command_refuses_without_a_card():
    res = subprocess.run([sys.executable, "-m", "vsrbench.run", "--workload",
                          "frvsr_4x_bd.infer_s4", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_a_run_with_jax_loaded_prints_no_result(tmp_path):
    root = toy.make_root(str(tmp_path))
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax');"
            "from vsrbench.tests import toy; "
            f"sys.exit(toy.main([{root!r}, 'frvsr_4x_bd.infer_s4', '0']))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 4
    assert res.stdout.strip() == ""
    assert "jax" in res.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import types
    for name in ("tecogan_tpu_torch", "tecogan_tpu_torch.ops", "jaxtyping",
                 "flaxy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tecogan_tpu.ops",
                        types.ModuleType("tecogan_tpu.ops"))
    assert harness.forbidden_modules() == ["tecogan_tpu"]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(PKG, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_under_vsrbench_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "tecogan_tpu_torch" not in set(_imports(path)), path
    code = ("import sys, vsrbench.reference.train, vsrbench.reference.nets;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    tops = json.loads(res.stdout.replace("'", '"'))
    assert "tecogan_tpu_torch" not in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_the_store_draws_each_sequences_contrast_from_the_seed(tmp_path):
    """With ``contrast`` in the traffic's store, each sequence's values
    spread about mid-grey by its own factor, drawn from the seed; without
    it the store is uniform noise, as the other cells have it."""
    import numpy as np
    import torch

    from tecogan_tpu_torch.data import UnpairedClipDataset
    from vsrbench.drivers.train_step import write_store

    def spreads(store, path):
        write_store(str(path), store, torch.Generator().manual_seed(3),
                    torch.device("cpu"))
        ds = UnpairedClipDataset(str(path), crop_size=16, tempo_extent=2,
                                 output_dtype=np.uint8)
        per_seq = len(ds) // store["sequences"]
        return [float(ds[(k * per_seq, np.random.default_rng(0))]["gt"]
                      .std()) for k in range(store["sequences"])]

    base = {"sequences": 4, "frames": 3, "height": 24, "width": 24}
    flat = spreads(base, tmp_path / "flat")
    varied = spreads(dict(base, contrast=[0.1, 1.0]), tmp_path / "varied")
    again = spreads(dict(base, contrast=[0.1, 1.0]), tmp_path / "again")
    assert max(flat) - min(flat) < 5          # uniform noise: std about 74
    assert max(varied) - min(varied) > 15     # one factor per sequence
    assert all(s <= 74 * 1.1 for s in varied)
    assert varied == again                    # the same seed, the same data
