"""Model FLOPs of the frames made in the traced sub-window (from shapes,
``vsrbench.counts``) over its seconds, as a share of the H100's dense bf16
peak."""

from vsrbench import counts


def read(rec):
    if rec.get("kind") != "infer":
        return None
    tr = rec["trace"]
    if tr.window_s <= 0 or not tr.units or tr.busy_s <= 0:
        return None
    flops = tr.units * rec["flops_per_frame"]
    return 100.0 * flops / tr.window_s / counts.PEAK_BF16_FLOPS
