"""Network factory (port of ``tecogan_tpu/models/networks/__init__.py``'s
generator half)."""

from .fnet import FNet
from .frnet import (FRNet, FRNetConfig, forward_sequence, infer_sequence,
                    infer_sequence_batch)
from .srnet import SRNet


def define_generator(opt):
    """opt -> (FRNetConfig, build_fn); ``build_fn(generator, device)``
    draws an FRNet's weights from a ``torch.Generator``. Reads the same
    YAML keys as the JAX package (``remat`` for the training unroll,
    ``compute_dtype`` for inference); generator name 'frnet' only."""
    g = opt["model"]["generator"]
    if g["name"].lower() != "frnet":
        raise ValueError(f"Unrecognized generator: {g['name']}")
    cfg = FRNetConfig(
        in_nc=g["in_nc"],
        out_nc=g["out_nc"],
        nf=g["nf"],
        nb=g["nb"],
        scale=opt["scale"],
        degradation=opt["dataset"]["degradation"]["type"],
        remat=g.get("remat", True),
        compute_dtype=g.get("compute_dtype", "float32"),
    )
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"generator.compute_dtype must be float32|bfloat16, got "
            f"{cfg.compute_dtype!r}")
    return cfg, (lambda generator, device="cpu":
                 FRNet.random(cfg, generator, device))


__all__ = [
    "FNet",
    "FRNet",
    "FRNetConfig",
    "SRNet",
    "define_generator",
    "forward_sequence",
    "infer_sequence",
    "infer_sequence_batch",
]
