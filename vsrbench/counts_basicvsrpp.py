"""BasicVSR++'s counts from shapes alone, beside ``counts.py``: the model
FLOPs of a whole-clip inference call and of its DCN, and the DCN's bytes.

FLOPs are 2 x multiply-adds of the convolutions and of the DCN's product
(as a 3x3 convolution of its 2m input channels); the warps, the DCN's
sampling, the resizes, the pooling and the activations are left out (under
1% of a frame). Per frame of a clip of t frames: the spatial features and
the reconstruction once a frame, SPyNet on the t - 1 pairs in both
directions, and in each of the four branches the backbone at every frame
and the alignment (conv_offset and the DCN) at every frame but the
branch's first.
"""

from __future__ import annotations

from .counts import DTYPE_BYTES, HBM_BYTES_PER_S, PEAK_BF16_FLOPS, _conv

SPYNET_CHANNELS = (8, 32, 64, 32, 16, 2)
SPYNET_LEVELS = 6
BRANCHES = 4


def _up32(v: int) -> int:
    return -(-v // 32) * 32


def spynet_flops(h: int, w: int) -> int:
    """One SPyNet flow at LR h x w: five 7x7 convolutions at each of six
    pyramid levels of the frame resized to multiples of 32."""
    hh, ww, total = _up32(h), _up32(w), 0
    for level in range(SPYNET_LEVELS):
        sh, sw = hh >> level, ww >> level
        total += sum(_conv(a, b, 7, sh, sw) for a, b in
                     zip(SPYNET_CHANNELS[:-1], SPYNET_CHANNELS[1:]))
    return total


def rb_flops(cin: int, m: int, blocks: int, h: int, w: int) -> int:
    """``RB(cin, m, blocks)``: the input convolution and two per block."""
    return _conv(cin, m, 3, h, w) + 2 * blocks * _conv(m, m, 3, h, w)


def dcn_flops(n: int, h: int, w: int, m: int) -> int:
    """The DCN of n frames: a 3x3 product of 2m channels to m."""
    return n * _conv(2 * m, m, 3, h, w)


def align_flops(h: int, w: int, m: int, groups: int) -> int:
    """One aligned frame step: conv_offset and the DCN."""
    return (_conv(3 * m + 4, m, 3, h, w) + 2 * _conv(m, m, 3, h, w)
            + _conv(m, 27 * groups, 3, h, w) + dcn_flops(1, h, w, m))


def frame_flops(t: int, h: int, w: int, m: int, nb: int,
                groups: int) -> float:
    """Model FLOPs per frame of a whole-clip call on clips of t frames of
    LR h x w (the clip's FLOPs over t)."""
    total = t * rb_flops(3, m, 5, h, w)
    total += 2 * (t - 1) * spynet_flops(h, w)
    for j in range(BRANCHES):
        total += ((t - 1) * align_flops(h, w, m, groups)
                  + t * rb_flops((2 + j) * m, m, nb, h, w))
    total += t * (rb_flops(5 * m, m, 5, h, w) + _conv(m, 4 * m, 3, h, w)
                  + _conv(m, 4 * m, 3, 2 * h, 2 * w)
                  + _conv(m, m, 3, 4 * h, 4 * w)
                  + _conv(m, 3, 3, 4 * h, 4 * w))
    return total / t


def dcn_bytes(n: int, h: int, w: int, m: int, groups: int,
              dtype: str) -> int:
    """The DCN of n frames at its bound: the 2m-channel input, the 27
    groups raw offset and mask channels and the two fp32 flows read once,
    the weight and bias read once, the m-channel output written once (the
    columns are the implementation's and are not counted)."""
    b = DTYPE_BYTES[dtype]
    per_pixel = (2 * m + 27 * groups + m) * b + 2 * 2 * DTYPE_BYTES["float32"]
    return n * h * w * per_pixel + (m * 2 * m * 9 + m) * b


def bound_seconds(nbytes: int, flops: int) -> float:
    """The least time the H100 takes: bytes at 3.35 TB/s or FLOPs at the
    dense bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
