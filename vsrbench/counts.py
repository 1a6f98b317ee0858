"""The yardstick's counts, from shapes alone: the model FLOPs of an
inference frame and of a training step, the bytes of the warp kernels at
their call shapes, and the H100's published peaks.

FLOPs are 2 x multiply-adds of the convolutions, transposed convolutions
and linear layers; the resamplers, warps, losses, normalisations and the
optimizer are left out (under 1% of a frame). A training pass counts its
forward once (no recomputation), its weight gradient where the weights
train, and its input gradient where the input needs one.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _conv(cin, cout, k, hout, wout):
    return 2 * cin * cout * k * k * hout * wout


def fnet_layers(h: int, w: int) -> list:
    """FNet's convolutions at LR h x w: (name, FLOPs of one image pair)."""
    out, cin = [], 6
    hh, ww = h, w
    for i, c in enumerate((32, 64, 128)):
        out += [(f"encoder{i + 1}.0", _conv(cin, c, 3, hh, ww)),
                (f"encoder{i + 1}.2", _conv(c, c, 3, hh, ww))]
        cin, hh, ww = c, hh // 2, ww // 2
    for i, c in enumerate((256, 128, 64)):
        out += [(f"decoder{i + 1}.0", _conv(cin, c, 3, hh, ww)),
                (f"decoder{i + 1}.2", _conv(c, c, 3, hh, ww))]
        cin, hh, ww = c, hh * 2, ww * 2
    out += [("flow.0", _conv(64, 32, 3, hh, ww)),
            ("flow.2", _conv(32, 2, 3, hh, ww))]
    return out


def srnet_layers(h: int, w: int, nf: int, nb: int, scale: int) -> list:
    """SRNet's layers at LR h x w: (name, FLOPs of one frame). A transposed
    convolution counts 2 * cin * cout * k * k per input pixel."""
    out = [("conv_in.0", _conv((scale * scale + 1) * 3, nf, 3, h, w))]
    out += [(f"resblocks.{i}.conv.{j}", _conv(nf, nf, 3, h, w))
            for i in range(nb) for j in (0, 2)]
    hh, ww = h, w
    for k in range({4: 2, 2: 1}[scale]):
        out.append((f"conv_up.{2 * k}", _conv(nf, nf, 3, hh, ww)))
        hh, ww = hh * 2, ww * 2
    out.append(("conv_out", _conv(nf, 3, 3, hh, ww)))
    return out


def d_layers(size: int, cin: int = 27) -> list:
    """The discriminator's layers on one (cin, size, size) input."""
    s = size
    out = [("conv_in.0", _conv(cin, 64, 3, s, s))]
    c = 64
    for i, co in enumerate((64, 64, 128, 256)):
        s //= 2
        out.append((f"discriminator_block.block{i + 1}.0",
                    _conv(c, co, 4, s, s)))
        c = co
    out.append(("dense", 2 * c * s * s))
    return out


VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512, 512, 512, 512]


def vgg_layers(h: int, w: int, last: int = 35) -> list:
    """VGG19's convolutions up to ``features[last]`` on one h x w image."""
    out, cin, idx, hh, ww = [], 3, 0, h, w
    for v in VGG_CFG:
        if idx > last:
            break
        if v == "M":
            hh, ww, idx = hh // 2, ww // 2, idx + 1
            continue
        out.append((f"features.{idx}", _conv(cin, v, 3, hh, ww)))
        cin, idx = v, idx + 2
    return out


def _sum(layers) -> int:
    return sum(f for _, f in layers)


def _pass(layers, wgrad: bool, dgrad_first: bool):
    """Forward + weight gradient (if ``wgrad``) + input gradient of every
    layer whose input needs one (the first's only if ``dgrad_first``)."""
    total = 2 * _sum(layers) - (0 if dgrad_first else layers[0][1])
    return total + (_sum(layers) if wgrad else 0)


def infer_frame_flops(h: int, w: int, nf: int, nb: int, scale: int) -> int:
    """Model FLOPs of one streamed frame at LR h x w: FNet on the (frame,
    previous) pair and SRNet."""
    return _sum(fnet_layers(h, w)) + _sum(srnet_layers(h, w, nf, nb, scale))


def generator_train_flops(n: int, t: int, h: int, w: int, nf: int, nb: int,
                          scale: int) -> int:
    """The generator's part of a training step on n clips of t LR frames:
    FNet on the n(t-1) pairs (its LR input needs no gradient), SRNet on
    every frame (the first frame's input is constant; the others' warped
    HR input carries the recurrence's gradient)."""
    fl = fnet_layers(h, w)
    sl = srnet_layers(h, w, nf, nb, scale)
    return (n * (t - 1) * _pass(fl, True, False)
            + n * _pass(sl, True, False) + n * (t - 1) * _pass(sl, True, True))


def tecogan_step_flops(n, te, h, w, nf, nb, scale, d_size,
                       d_update=True) -> int:
    """A TecoGAN step on n clips of te LR frames, ping-pong doubled to
    2te - 1: the generator; the discriminator's real and detached fake
    forwards (trained where the vote passes) and its third forward for the
    generator (input gradient only); VGG19 on the fake frames (input
    gradient) and on the te unique real frames (forward)."""
    t = 2 * te - 1
    clips = n * ((t // 3 * 3) // 3)
    dl = d_layers(d_size)
    vl = vgg_layers(scale * h, scale * w)
    total = generator_train_flops(n, t, h, w, nf, nb, scale)
    total += 2 * clips * (_pass(dl, True, False) if d_update else _sum(dl))
    total += clips * _pass(dl, False, True)
    total += n * t * _pass(vl, False, True) + n * te * _sum(vl)
    return total


def warp_bytes(n: int, c: int, h: int, w: int, image: str, flow: str) -> int:
    """K1 (and K2): the image and the flow read once, the output written
    once."""
    bi, bf = DTYPE_BYTES[image], DTYPE_BYTES[flow]
    return n * h * w * (2 * c * bi + 2 * bf)


def warp_adjoint_bytes(n: int, c: int, h: int, w: int, image: str,
                       flow: str) -> int:
    """Fused K3+K4: the cotangent, the image and the flow read once, the
    image and flow adjoints written once (its int64 scratch is the
    kernel's own and not counted)."""
    bi, bf = DTYPE_BYTES[image], DTYPE_BYTES[flow]
    return n * h * w * (3 * c * bi + 4 * bf)


def bound_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
