"""The benchmark's registry and result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``   the configuration (``BENCHMARK.json`` names
  the file);
- ``traffic/<traffic>.json``  the traffic mix: its ``driver`` and the
  driver's parameters;
- ``drivers/<driver>.py``     the general code of a kind of traffic;
- ``limits/<cell>.json``      the limits of the cell's correctness check;
- ``metrics/<metric>.py``     the reader of one per-layer metric, a
  function ``read(rec)`` that returns a number or None. ``rec`` is the
  traced sub-window's record: the driver's (``kind``, ``trace``, the
  driver's own keys) with ``memory_peak_bytes`` and ``launches`` (the
  program's kernel launches by kernel) over it (``run.traced``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "tecogan_tpu")


class Refused(Exception):
    """The run cannot be made (no card, a missing file): no result."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: str = HERE) -> dict:
    """The cell ``name`` of ``bench`` with its configuration entry, its
    configuration, traffic mix and limits loaded (``root``: the folder
    that holds ``traffic/`` and ``limits/``), and the metrics it
    reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_entry"] = configs[cell["config"]]
    cell["config_data"] = load_json(cell["config_entry"]["file"])
    cell["mix"] = load_json(os.path.join(root, "traffic",
                                         cell["traffic"] + ".json"))
    cell["limits"] = load_json(os.path.join(root, "limits", name + ".json"))
    cell["root"] = root
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if (name in m["workloads"] if "workloads" in m
                             else m["moves"] in e2e)]
    return cell


def driver(kind: str):
    """The traffic driver module ``drivers/<kind>.py``."""
    return importlib.import_module(f"vsrbench.drivers.{kind}")


def reader(metric: str, root: str = HERE):
    """The ``read`` function of ``<root>/metrics/<metric>.py``."""
    path = os.path.join(root, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "vsrbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, rec: dict, root: str = HERE) -> dict:
    """Each per-layer metric that its reader finds something for."""
    out = {}
    for m in entries:
        value = reader(m["name"], root)(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``tecogan_tpu_torch`` is not ``tecogan_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def verdict(checks: list) -> bool:
    """Every compared number at or under its limit (a number that could
    not be read fails)."""
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks)


def check_lines(checks: list) -> list:
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r}"
            for c in checks]


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return json.dumps(out)
