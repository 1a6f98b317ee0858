"""CLI + YAML configuration (port of ``tecogan_tpu/utils/config.py``).

The flags and their defaults are the JAX CLI's. ``--gpu_ids`` names the
CUDA devices: '-1' is the CPU (``device_ids: []``), '0' the first card.
``--local_rank`` is accepted and ignored. The YAML is read by
``utils/yaml_subset.py``, since PyYAML is not a dependency of the port.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from .yaml_subset import safe_load

__all__ = ["parse_args", "parse_configs", "setup_random_seed"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tecogan_tpu_torch CLI")
    p.add_argument("--exp_dir", type=str, required=True,
                   help="directory of the current experiment")
    p.add_argument("--mode", type=str, required=True,
                   help="train | test | profile")
    p.add_argument("--opt", type=str, required=True,
                   help="path to the option yaml file")
    p.add_argument("--gpu_ids", type=str, default="0",
                   help="device ids to use (-1 for cpu)")
    p.add_argument("--lr_size", type=str, default="3x134x320",
                   help="CxHxW size of the input frame (profile mode)")
    p.add_argument("--test_speed", action="store_true",
                   help="measure FPS in profile mode")
    p.add_argument("--local_rank", type=int, default=0,
                   help="ignored (kept for CLI compatibility)")
    return p.parse_args(argv)


def parse_configs(args):
    """Load the YAML into an opt dict and inject runtime settings."""
    with open(args.opt, "r") as f:
        opt = safe_load(f.read())

    opt["exp_dir"] = args.exp_dir
    opt["mode"] = args.mode
    opt["is_train"] = args.mode == "train"

    # device selection: '-1' is the CPU, other ids name CUDA devices
    ids = [int(i) for i in str(args.gpu_ids).split(",") if i != ""]
    opt["device_ids"] = [] if ids == [-1] else ids
    opt["gpu_ids"] = args.gpu_ids

    setup_random_seed(opt.get("manual_seed", 2021))
    return opt


def setup_random_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
