"""Network factories (port of ``tecogan_tpu/models/networks/__init__.py``)."""

from .discriminators import (DTrunk, SNetConfig, STNetConfig, build_d_input,
                             build_flow_merge, build_stnet_input)
from .fnet import FNet
from .frnet import (FRNet, FRNetConfig, forward_sequence, infer_sequence,
                    infer_sequence_batch)
from .frnet_sp import infer_sequence_sp
from .srnet import SRNet
from .vgg import VGG19


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


def define_discriminator(opt):
    """opt -> (STNetConfig | SNetConfig, build_fn) for 'stnet' | 'snet';
    ``build_fn(generator, device)`` draws a ``DTrunk``'s weights from a
    ``torch.Generator``. The input's spatial size is the training crop:
    ``crop_size`` for BD, ``gt_crop_size`` for BI."""
    d = opt["model"]["discriminator"]
    degradation = opt["dataset"]["degradation"]["type"]
    train_ds = opt["dataset"]["train"]
    spatial_size = (train_ds["crop_size"] if degradation == "BD"
                    else train_ds["gt_crop_size"])
    name = d["name"].lower()
    if name == "stnet":
        cfg = STNetConfig(in_nc=d["in_nc"], spatial_size=spatial_size,
                          tempo_range=d["tempo_range"])
    elif name == "snet":
        cfg = SNetConfig(in_nc=d["in_nc"], spatial_size=spatial_size,
                         use_cond=d["use_cond"])
    else:
        raise ValueError(f"Unrecognized discriminator: {d['name']}")
    return cfg, (lambda generator, device="cpu":
                 DTrunk.random(cfg, generator, device))


__all__ = [
    "DTrunk",
    "FNet",
    "FRNet",
    "FRNetConfig",
    "SNetConfig",
    "SRNet",
    "STNetConfig",
    "VGG19",
    "build_d_input",
    "build_flow_merge",
    "build_stnet_input",
    "define_discriminator",
    "define_generator",
    "forward_sequence",
    "infer_sequence",
    "infer_sequence_batch",
    "infer_sequence_sp",
]
