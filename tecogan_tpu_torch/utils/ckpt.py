"""Checkpoint files, numpy only (port of ``tecogan_tpu/utils/ckpt.py``).

Native generator checkpoints are flat ``.npz`` files whose keys are
'/'-joined pytree paths, in the JAX package's layout; reference
checkpoints are ``.pth`` state dicts. The port's full training state
(weights, Adam state, step, running log) is ``state_iter{N}.pth``
(``models/base.py``).
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

__all__ = ["save_pytree", "load_pytree", "load_generator_params",
           "latest_training_state"]

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        # in sorted key order: the order of the JAX package's files, whose
        # save_pytree flattens a tree that jax.device_get rebuilt sorted
        for k, v in sorted(tree.items(), key=lambda kv: str(kv[0])):
            if not isinstance(k, str) or _SEP in k or k.startswith("#"):
                # such keys would not round-trip through the path syntax
                raise ValueError(
                    f"cannot checkpoint dict key {k!r} at {prefix!r}: "
                    f"keys must be '{_SEP}'-free, non-'#' strings")
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}

    return fix(tree)


def save_pytree(tree, path):
    """A nested dict/tuple of numpy arrays -> ``.npz``, written to a
    pid-unique temporary name and renamed into place."""
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)


def load_pytree(path):
    """A ``.npz`` checkpoint -> nested dict (tuples for '#i' keys)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def load_generator_params(path, nb: int = 10, scale: int = 4) -> dict:
    """Generator weights from a native ``.npz`` or a reference ``.pth``,
    as the port's state dict."""
    from .layout import load_state_dict, state_dict_from_jax

    if str(path).endswith(".pth"):
        return load_state_dict(path)
    return state_dict_from_jax(load_pytree(path), nb, scale)


def latest_training_state(ckpt_dir):
    """The most recent ``state_iter{N}.pth`` in ckpt_dir, or None."""
    if not osp.isdir(ckpt_dir):
        return None
    cands = []
    for f in os.listdir(ckpt_dir):
        if f.startswith("state_iter") and f.endswith(".pth"):
            try:
                cands.append((int(f[len("state_iter"):-len(".pth")]), f))
            except ValueError:
                pass
    if not cands:
        return None
    return osp.join(ckpt_dir, max(cands)[1])
