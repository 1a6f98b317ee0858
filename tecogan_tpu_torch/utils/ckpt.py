"""Checkpoint reading, numpy only (the loading half of
``tecogan_tpu/utils/ckpt.py``).

Native checkpoints are flat ``.npz`` files whose keys are '/'-joined
pytree paths; reference checkpoints are ``.pth`` state dicts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_pytree", "load_generator_params"]

_SEP = "/"


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


def load_pytree(path):
    """A ``.npz`` checkpoint -> nested dict (tuples for '#i' keys)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


def load_generator_params(path, nb: int = 10, scale: int = 4) -> dict:
    """Generator weights from a native ``.npz`` or a reference ``.pth``,
    as the port's state dict."""
    from ..models import convert

    if str(path).endswith(".pth"):
        return convert.load_state_dict(path)
    return convert.state_dict_from_jax(load_pytree(path), nb, scale)
