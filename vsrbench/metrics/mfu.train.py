"""Model FLOPs of the training steps in the traced sub-window (forward and
the backward's weight and input gradients from shapes, no recomputation,
``vsrbench.counts``) over its seconds, as a share of the H100's dense bf16
peak."""

from vsrbench import counts


def read(rec):
    if rec.get("kind") != "train":
        return None
    tr = rec["trace"]
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * rec["flops_in_trace"] / tr.window_s / \
        counts.PEAK_BF16_FLOPS
