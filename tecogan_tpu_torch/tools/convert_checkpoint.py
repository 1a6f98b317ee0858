"""Checkpoint conversion: reference PyTorch ``.pth`` <-> the JAX package's
``.npz`` layout (port of ``scripts/convert_checkpoint.py``)::

    # a reference generator checkpoint -> .npz
    python -m tecogan_tpu_torch.tools.convert_checkpoint \\
        --src G_iter400000.pth --dst G.npz --kind frnet --nb 10 --scale 4
    # an .npz generator back to the reference's .pth
    python -m tecogan_tpu_torch.tools.convert_checkpoint \\
        --src G.npz --dst G.pth --kind frnet
    # a discriminator, or a torchvision VGG19 for the perceptual loss
    python -m tecogan_tpu_torch.tools.convert_checkpoint --src D.pth \\
        --dst D.npz --kind stnet --spatial_size 128
    python -m tecogan_tpu_torch.tools.convert_checkpoint --src vgg19.pth \\
        --dst pretrained_models/vgg19.npz --kind vgg19

The ``.npz`` holds the keys, shapes, dtypes (float32) and values the JAX
script writes, through the port's bridges (``models/convert.py``) and
``utils/ckpt.save_pytree``. Conversion is host work: no device.
"""

from __future__ import annotations

import argparse

import torch

from ..models import convert
from ..utils.ckpt import load_pytree, save_pytree


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.convert_checkpoint")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--kind", default="frnet",
                   choices=["frnet", "stnet", "vgg19"])
    p.add_argument("--nb", type=int, default=10)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--spatial_size", type=int, default=128)
    args = p.parse_args(argv)

    if args.src.endswith(".pth"):
        sd = convert.load_state_dict(args.src)
        if args.kind == "frnet":
            tree = convert.jax_from_state_dict(sd, args.nb, args.scale)
        elif args.kind == "stnet":
            tree = convert.jax_from_d_state_dict(sd, args.spatial_size)
        else:
            tree = convert.vgg19_jax_from_state_dict(sd)
        save_pytree(tree, args.dst)
    else:
        if args.kind != "frnet":
            raise SystemExit("only frnet exports to .pth")
        sd = convert.state_dict_from_jax(load_pytree(args.src), args.nb,
                                         args.scale)
        torch.save(sd, args.dst)
    print(f"{args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
