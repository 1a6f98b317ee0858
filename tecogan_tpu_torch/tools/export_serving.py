"""Export a serving artifact of the streaming SR program (port of
``scripts/export_serving.py``)::

    python -m tecogan_tpu_torch.tools.export_serving --ckpt G_iterN.npz \
        --out model.tecosrv --height 134 --width 320 --frames 64 \
        [--streams 1] [--chunk 16] [--scale 4] [--degradation BD] \
        [--nf 64] [--nb 10] [--compute_dtype bfloat16] [--packed16] \
        [--platforms cuda|cpu] [--no_embed_params]

The artifact embeds the generator's weights unless ``--no_embed_params``
and is served by ``python -m tecogan_tpu_torch.serve model.tecosrv lr_dir
out_dir``, or from Python::

    from tecogan_tpu_torch.serving import load_artifact
    run, meta, params = load_artifact("model.tecosrv")
    sr = run(params, lr_batch)        # uint8 (n, t, s*h, s*w, 3)

``--platforms`` names the one platform the program runs on: ``cuda`` (the
default; the export then needs a card) or ``cpu``. ``--packed16`` exports
the phase-plane recurrence (K5) in place of the default one (K1).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Returns (artifact bytes, meta)."""
    ap = argparse.ArgumentParser(
        prog="python -m tecogan_tpu_torch.tools.export_serving")
    ap.add_argument("--ckpt", required=True,
                    help="generator checkpoint (.npz or .pth): fixes the "
                         "weights' names, shapes and dtypes the program "
                         "takes")
    ap.add_argument("--out", required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--degradation", default="BD", choices=["BD", "BI"])
    ap.add_argument("--nf", type=int, default=64)
    ap.add_argument("--nb", type=int, default=10)
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--packed16", action="store_true",
                    help="the phase-plane recurrence (K5)")
    ap.add_argument("--platforms", nargs="*", default=None,
                    help="the target platform, cuda (default) or cpu")
    ap.add_argument("--no_embed_params", action="store_true",
                    help="ship a weights-free artifact (the serving host "
                         "must pass --ckpt / its own params)")
    args = ap.parse_args(argv)

    from ..models.networks import FRNetConfig
    from ..serving import export_stream, resolve_platform, save_artifact
    from ..utils.ckpt import load_generator_params

    platform = resolve_platform(args.platforms)
    params = load_generator_params(args.ckpt, nb=args.nb, scale=args.scale)
    cfg = FRNetConfig(nf=args.nf, nb=args.nb, scale=args.scale,
                      degradation=args.degradation,
                      compute_dtype=args.compute_dtype,
                      packed16=args.packed16)
    blob = export_stream(params, cfg, args.streams, args.frames,
                         args.height, args.width, chunk=args.chunk,
                         platforms=[platform])
    meta = {"n": args.streams, "t": args.frames, "h": args.height,
            "w": args.width, "scale": args.scale, "chunk": args.chunk,
            "degradation": args.degradation, "nf": args.nf, "nb": args.nb,
            "compute_dtype": args.compute_dtype, "packed16": args.packed16,
            "platforms": [platform]}
    save_artifact(args.out, blob, meta,
                  params=None if args.no_embed_params else params)
    print(f"exported {len(blob) / 1e6:.1f} MB artifact -> {args.out}")
    print(f"meta: {meta}")
    return blob, meta


if __name__ == "__main__":
    main()
