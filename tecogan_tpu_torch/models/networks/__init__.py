"""Network factories (port of ``tecogan_tpu/models/networks/__init__.py``)."""

from .basicvsrpp import BasicVSRPP, BasicVSRPPConfig, infer_clip_batch
from .discriminators import (DTrunk, SNetConfig, STNetConfig, build_d_input,
                             build_flow_merge, build_stnet_input)
from .fnet import FNet
from .frnet import (FRNet, FRNetConfig, forward_sequence, infer_sequence,
                    infer_sequence_batch)
from .frnet_sp import infer_sequence_sp
from .srnet import SRNet
from .vgg import VGG19


def define_generator(opt):
    """opt -> (config, build_fn); ``build_fn(generator, device)`` draws the
    generator's weights from a ``torch.Generator``.

    'frnet' (``FRNetConfig``, ``FRNet``) reads the same YAML keys as the
    JAX package (``remat`` for the training unroll, ``compute_dtype`` for
    inference). 'basicvsrpp' (``BasicVSRPPConfig``, ``BasicVSRPP``, 4x
    only, inference only) reads mmagic's ``mid_channels``, ``num_blocks``,
    ``max_residue_magnitude`` and ``deform_groups`` (defaults: the
    published c64n7 model) and ``compute_dtype``."""
    g = opt["model"]["generator"]
    name = g["name"].lower()
    if name == "basicvsrpp":
        if opt["scale"] != 4:
            raise ValueError(f"BasicVSRPP upsamples 4x; scale is "
                             f"{opt['scale']}")
        cfg = BasicVSRPPConfig(
            mid_channels=g.get("mid_channels", 64),
            num_blocks=g.get("num_blocks", 7),
            max_residue_magnitude=float(g.get("max_residue_magnitude", 10)),
            deform_groups=g.get("deform_groups", 16),
            compute_dtype=g.get("compute_dtype", "float32"))
        _check_dtype(cfg.compute_dtype)
        return cfg, (lambda generator, device="cpu":
                     BasicVSRPP.random(cfg, generator, device))
    if name != "frnet":
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
    _check_dtype(cfg.compute_dtype)
    return cfg, (lambda generator, device="cpu":
                 FRNet.random(cfg, generator, device))


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"generator.compute_dtype must be float32|bfloat16, got "
            f"{compute_dtype!r}")


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
    "BasicVSRPP",
    "BasicVSRPPConfig",
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
    "infer_clip_batch",
    "infer_sequence",
    "infer_sequence_batch",
    "infer_sequence_sp",
]
