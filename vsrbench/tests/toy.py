"""A toy copy of the benchmark's cells for CPU tests: the same files and
drivers, at widths and sizes a CPU run holds (nf 8, nb 1; 2 clips of 5
frames of 12x20 for inference; 2 clips of 10 frames at 32^2 crops for
training, 4 for the FRVSR cell).

    python -m vsrbench.tests.toy <root> <cell> <trace 0|1> [fault]

builds nothing: it runs one cell of the toy root ``make_root`` wrote on the
CPU (the card check skipped), with a planted fault when named, and prints
what ``vsrbench.run`` prints.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)

TOY_CONFIG = {"generator": {"nf": 8, "nb": 1}, "train": {"crop_size": 32}}
TOY_TRAFFIC = {
    "infer_s4": {"streams": 2, "frames": 5, "height": 12, "width": 20,
                 "chunk": 3, "pool": 2},
    "train_b64": {"batch": 2, "loader_workers": 1, "steps_per_sync": 2,
                  "store": {"sequences": 2, "frames": 12, "height": 64,
                            "width": 64}},
}
# the FRVSR cell's store varies its contrast by sequence: 4 clips from 4
# sequences, so that a toy batch is not all dim clips
TOY_TRAFFIC["train_b512"] = {
    "batch": 4, "loader_workers": 1, "steps_per_sync": 2,
    "store": {"sequences": 4, "frames": 12, "height": 64, "width": 64,
              "contrast": [0.1, 1.0]}}


def shrink():
    """The drivers' own counts cut for a CPU run: the checked call or step
    among the first 2 units, one dispatch sample, one traced unit."""
    from vsrbench.drivers import infer_batch, train_step

    infer_batch.SAMPLE_FROM_FIRST = train_step.WINDOW_CHECK_UNITS = 2
    infer_batch.DISPATCH_SAMPLES = train_step.DISPATCH_SAMPLES = 1
    infer_batch.TRACE_UNITS = train_step.TRACE_UNITS = 1


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and \
            isinstance(base.get(k), dict) and k != "store" else v
    return out


def make_root(root: str, limits: dict | None = None) -> str:
    """A benchmark root under ``root``: ``BENCHMARK.json`` and the data
    folders, every configuration and traffic mix cut to toy sizes;
    ``limits`` (cell -> checks) replaces the committed limits."""
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(root, d),
                        dirs_exist_ok=True)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(root, "configs", c["name"] + ".json")
        with open(path) as f:
            cfg = _merge(json.load(f), TOY_CONFIG)
        with open(path, "w") as f:
            json.dump(cfg, f)
        c["file"] = path
    for name, over in TOY_TRAFFIC.items():
        path = os.path.join(root, "traffic", name + ".json")
        with open(path) as f:
            mix = _merge(json.load(f), over)
        with open(path, "w") as f:
            json.dump(mix, f)
    for cell, checks in (limits or {}).items():
        with open(os.path.join(root, "limits", cell + ".json"), "w") as f:
            json.dump({"checks": checks}, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def main(argv) -> int:
    import torch

    from vsrbench import calibrate, harness, run

    root, name, trace = argv[0], argv[1], bool(int(argv[2]))
    torch.set_num_threads(2)
    shrink()
    cell = harness.find_cell(
        harness.load_json(os.path.join(root, "BENCHMARK.json")), name, root)
    if len(argv) > 3:
        with calibrate.planted(argv[3]):
            return run.run_cell(cell, 2 ** 31 + 77, 0.3, trace,
                                torch.device("cpu"))
    return run.run_cell(cell, 2 ** 31 + 77, 0.3, trace, torch.device("cpu"))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
