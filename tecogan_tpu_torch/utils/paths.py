"""Experiment path setup (copied from ``tecogan_tpu/utils/paths.py``).

Test mode expands ``model.generator.load_path``: a file name ``*.npz``
(or ``*.pth``) sweeps ``G_iter{N}`` for N in ``range(test.start_iter,
test.end_iter + 1, test.test_freq)``. Relative paths resolve against the
current directory, as in the JAX package.
"""

from __future__ import annotations

import os
import os.path as osp

__all__ = ["setup_paths", "retrieve_files"]


def retrieve_files(d, suffix=("png", "jpg")):
    """All files under ``d`` (recursively) with the given suffixes, sorted."""
    if not d:
        return []
    if isinstance(suffix, str):
        suffix = suffix.split("|")
    exts = {"." + s.lower() for s in suffix}
    out = []
    for root, dirs, files in os.walk(d):
        dirs.sort()
        for f in files:
            if osp.splitext(f)[-1].lower() in exts:
                out.append(osp.join(root, f))
    return sorted(out)


def _default_dir(opt, section, key, *parts):
    d = opt[section].get(key) or osp.join(opt["exp_dir"], *parts)
    opt[section][key] = d
    os.makedirs(d, exist_ok=True)


def _expand_load_paths(opt):
    load_path = opt["model"]["generator"].get("load_path", "")
    if not load_path:
        raise ValueError("a pretrained generator is required for testing")
    ckpt_dir, model_idx = osp.split(load_path)
    model_idx, ext = osp.splitext(model_idx)
    if model_idx == "*":
        start = opt["test"]["start_iter"]
        end = opt["test"]["end_iter"]
        freq = opt["test"]["test_freq"]
        opt["model"]["generator"]["load_path_lst"] = [
            osp.join(ckpt_dir, f"G_iter{i}{ext or '.npz'}")
            for i in range(start, end + 1, freq)
        ]
    else:
        opt["model"]["generator"]["load_path_lst"] = [load_path]


def setup_paths(opt, mode):
    has_test_set = any("test" in k for k in opt.get("dataset", {}))

    if mode == "train":
        _default_dir(opt, "train", "ckpt_dir", "train", "ckpt")
    elif mode == "test":
        _expand_load_paths(opt)

    if mode in ("train", "test") and has_test_set:
        if opt.get("test", {}).get("save_res", False):
            _default_dir(opt, "test", "res_dir", "test", "results")
        if opt.get("test", {}).get("save_json", False):
            _default_dir(opt, "test", "json_dir", "test", "metrics")
