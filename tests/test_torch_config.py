"""The port's configuration: its YAML subset reader against
``yaml.safe_load``, and its CLI flags against the JAX CLI's."""

import glob
import math
import os.path as osp

import pytest
import yaml

from tecogan_tpu.utils import config as jconfig
from tecogan_tpu_torch.utils import config as tconfig
from tecogan_tpu_torch.utils.yaml_subset import safe_load

_REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SHIPPED = sorted(osp.relpath(p, _REPO) for p in glob.glob(
    osp.join(_REPO, "experiments_*", "**", "*.yml"), recursive=True))


def test_all_shipped_configs_are_covered():
    assert len(_SHIPPED) == 16


@pytest.mark.parametrize("path", _SHIPPED)
def test_shipped_config_matches_pyyaml(path):
    with open(osp.join(_REPO, path)) as f:
        text = f.read()
    assert safe_load(text) == yaml.safe_load(text)


def _tiny_exp_opt():
    """tests/test_cli.py::tiny_exp's train.yml dict, with a test sweep."""
    return {
        "scale": 4, "manual_seed": 0, "verbose": False,
        "dataset": {
            "degradation": {"type": "BD", "sigma": 1.5},
            "train": {"name": "VimeoTecoGAN", "seq_dir": "/tmp/x/GT.rec",
                      "data_type": "rgb", "crop_size": 32,
                      "batch_size_per_gpu": 1, "num_worker_per_gpu": 1,
                      "pin_memory": True},
            "test": {"name": "Toy", "gt_seq_dir": "/tmp/x/ValGT",
                     "num_worker_per_gpu": 1, "pin_memory": True},
        },
        "model": {"name": "FRVSR",
                  "generator": {"name": "FRNet", "in_nc": 3, "out_nc": 3,
                                "nf": 8, "nb": 2}},
        "train": {"tempo_extent": 3, "start_iter": 0, "total_iter": 2,
                  "moving_first_frame": True, "moving_factor": 0.7,
                  "generator": {"lr": 1e-4,
                                "lr_schedule": {"type": "FixedLR"},
                                "betas": [0.9, 0.999]},
                  "pixel_crit": {"type": "CB", "weight": 1,
                                 "reduction": "mean"},
                  "warping_crit": {"type": "CB", "weight": 1,
                                   "reduction": "mean"}},
        "test": {"test_freq": 2, "save_res": False, "res_dir": None,
                 "save_json": True, "json_dir": None,
                 "padding_mode": "reflect", "num_pad_front": 2},
        "metric": {"PSNR": {"colorspace": "y"}},
        "logger": {"log_freq": 1, "decay": 0.99, "ckpt_freq": 2},
        "strings": ["000", "1e-4", "yes", "null", "a: b", "#x", "", "-x",
                    " lead", "it's", "tab\there"],
        "numbers": [-3, 0, 1e20, 5e-05, -0.5, float("inf")],
    }


def test_safe_dump_round_trip():
    text = yaml.safe_dump(_tiny_exp_opt())
    assert safe_load(text) == yaml.safe_load(text) == _tiny_exp_opt()


# YAML 1.1 scalar resolution as PyYAML does it (the configs' traps first)
_SCALARS = ["5.0e-05", "0.1", "1e-4", "'000'", "1.0e5", "3.0e+5", "1.",
            ".5", "+.5", "012", "08", "0x1F", "0b101", "1_000", "1:30",
            "-1:30.5", "~", "null", "Null", "", "yes", "No", "on", "OFF",
            "y", ".inf", "-.Inf", "'it''s'", '"a\\tb\\u00e9"', "a b  # c",
            "a#b", "-x", "https://x.org/a:b"]


@pytest.mark.parametrize("scalar", _SCALARS)
def test_scalar_resolution_matches_pyyaml(scalar):
    text = f"key: {scalar}\n"
    want, got = yaml.safe_load(text)["key"], safe_load(text)["key"]
    assert type(got) is type(want) and got == want


def test_nan_and_structure():
    assert math.isnan(safe_load("a: .NaN")["a"])
    text = ("# comment\nseq:\n- 1\n- - x\n  - y\n-\n  k: v\n- a: 1\n"
            "  b: '2'\nmap:\n  inner:  # trailing\n    deep: ~\n  empty:\n"
            "top: 3\n")
    assert safe_load(text) == yaml.safe_load(text)
    assert safe_load("") is None and safe_load("# only\n") is None


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: [1, 2]\n", 2),        # flow sequence
    ("a:\n  b: {}\n", 2),            # flow mapping
    ("a: &x 1\n", 1),                # anchor
    ("a: 1\nb: *x\n", 2),            # alias
    ("a: !!str 1\n", 1),             # tag
    ("a: |\n  x\n", 1),              # block scalar
    ("a: >\n  x\n", 1),
    ("a: x\n  y\n", 2),              # multi-line plain scalar
    ("a: 'x\n  y'\n", 1),            # multi-line quoted scalar
    ("a: 1\n---\nb: 2\n", 2),        # document marker
    ("a: 2001-12-14\n", 1),          # timestamp
    ("a:\n\tb: 1\n", 2),             # tab indentation
    ("a: b: c\n", 1),
    ("a:\n  b: 1\n c: 2\n", 3),      # bad indentation
])
def test_unsupported_syntax_raises_with_its_line(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        safe_load(text)


@pytest.mark.parametrize("argv", [
    ["--exp_dir", "E", "--mode", "test", "--opt", "E/test.yml"],
    ["--exp_dir", "E", "--mode", "profile", "--opt", "o.yml", "--gpu_ids",
     "-1", "--lr_size", "3x32x32", "--test_speed", "--local_rank", "2"],
    ["--mode=train", "--opt=o.yml", "--exp_dir=E", "--gpu_ids=0,1"],
])
def test_parse_args_matches_jax(argv):
    assert vars(tconfig.parse_args(argv)) == vars(jconfig.parse_args(argv))


def test_parse_args_requires_the_same_flags():
    for parse in (jconfig.parse_args, tconfig.parse_args):
        with pytest.raises(SystemExit):
            parse(["--mode", "test", "--opt", "o.yml"])


@pytest.mark.parametrize("gpu_ids,want", [
    ("-1", []), ("0", [0]), ("1", [1]), ("0,1", [0, 1])])
def test_device_ids_mapping(tmp_path, gpu_ids, want):
    opt_path = tmp_path / "test.yml"
    opt_path.write_text("scale: 4\nmanual_seed: 3\n")
    argv = ["--exp_dir", str(tmp_path), "--mode", "test", "--opt",
            str(opt_path), "--gpu_ids", gpu_ids]
    got = tconfig.parse_configs(tconfig.parse_args(argv))
    assert got == jconfig.parse_configs(jconfig.parse_args(argv))
    assert got["device_ids"] == want and got["gpu_ids"] == gpu_ids
    assert got["is_train"] is False and got["exp_dir"] == str(tmp_path)
