"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program, drives the rest of a run
(the card check skipped, toy widths on the CPU, the cell's committed
limits), and the result line reads ``correct: false``; the same run
unbroken reads ``correct: true``. Besides the contract's faults, the
training cells plant ``dflow`` (the warps' adjoints with respect to the
flow zeroed), which only FNet's numbers see. The exchange between chips
has no fault here: every cell runs on one chip."""

from __future__ import annotations

import json

import pytest

from vsrbench.tests import toy
from vsrbench.tests.test_vsrbench_harness import _run_toy

FAULTS = {
    "frvsr_4x_bd.infer_s4": ["frozen", "half", "repeat"],
    "tecogan_4x_bd.train_b64": ["frozen", "half", "dflow"],
    "frvsr_4x_bd.train_b512": ["frozen", "half", "dflow"],
}
RUNS = [(cell, None) for cell in FAULTS] + [
    (cell, fault) for cell, faults in FAULTS.items() for fault in faults]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.make_root(str(tmp_path_factory.mktemp("toy")))


@pytest.mark.parametrize("cell,fault", RUNS)
def test_a_planted_fault_reads_not_correct(root, cell, fault):
    res = _run_toy(root, cell, 0, fault)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is (fault is None), line["checks"]
