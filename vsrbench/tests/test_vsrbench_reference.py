"""The plain reference against the program on the CPU at toy widths: in
fp32 they compute the same function (inference bit for bit, training to
fp32 rounding, at the start and at the window's step); in the
configuration's bf16 the program departs by its rounding; the fp8 control
departs several times further, so the check can tell them apart, and the
cell's committed limits judge it not correct; a fault that starts only
after set-up is caught by the window's step."""

from __future__ import annotations

import copy

import pytest
import torch

from vsrbench import calibrate, harness
from vsrbench.drivers import train_step
from vsrbench.tests import toy

CELLS = ["frvsr_4x_bd.infer_s4", "tecogan_4x_bd.train_b64",
         "frvsr_4x_bd.train_b512"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    toy.shrink()
    return toy.make_root(str(tmp_path_factory.mktemp("toy")))


def _cell(root, name, fp32=False):
    cell = harness.find_cell(harness.load_json(root + "/BENCHMARK.json"),
                             name, root)
    if fp32:
        cell = copy.deepcopy(cell)
        cell["config_data"]["train"]["mixed_precision"] = False
        cell["config_data"]["inference"]["compute_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_fp32_program_is_the_reference(root, name):
    got = calibrate.program_reading(_cell(root, name, fp32=True), 11,
                                    torch.device("cpu"))
    if "infer" in name:
        assert got == {"frame_mad_worst": 0.0, "frame_mad_mean": 0.0,
                       "max_abs": 0.0}
    else:
        for part in ("", "win."):
            assert got[part + "loss_gap"] < 1e-5
            assert got[part + "grad_gap"] < 1e-3
            assert got[part + "change_gap"] < 1e-3
            assert got.get(part + "vote_gap", 0.0) < 1e-5
            assert got.get(part + "vote_rule", 0.0) == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_reads_far_above_the_bf16_program(root, name):
    dev = torch.device("cpu")
    prog = calibrate.program_reading(_cell(root, name), 12, dev)
    ctrl = calibrate.control_reading(_cell(root, name), 12, dev)
    ratios = {k: ctrl[k] / v for k, v in prog.items()
              if k in ctrl and isinstance(v, float) and v > 0}
    assert max(ratios.values()) >= 3.0, (prog, ctrl)


@pytest.mark.parametrize("name", CELLS)
def test_the_committed_limits_judge_the_control_not_correct(root, name):
    ctrl = calibrate.control_reading(_cell(root, name), 13,
                                     torch.device("cpu"))
    assert calibrate.judged(_cell(root, name), ctrl)["correct"] is False


@pytest.mark.parametrize("name", CELLS[1:])
def test_a_fault_that_starts_in_the_window_is_caught_there(root, name,
                                                           monkeypatch):
    """The optimizer stops updating once set-up is over: the start's
    numbers pass, the window step's fail."""
    cell = _cell(root, name)
    drv = train_step.Driver(cell["config_data"], cell["mix"], 14,
                            torch.device("cpu"))
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    while drv.pending():
        drv.unit()
    drv.release()
    checks = drv.check(cell["limits"])
    start = [c for c in checks if not c["name"].startswith("win.")]
    assert harness.verdict(start), start
    assert not harness.verdict(checks), checks
