"""The fused K3+K4 launch's share of its roofline at the step's adjoint
shape: the cotangent, image and flow read once, both adjoints written once,
at 3.35 TB/s, over its mean device time in the trace."""

import statistics

from vsrbench import counts


def read(rec):
    if rec.get("kind") != "train":
        return None
    times = rec["trace"].kernel_times("warp_dimage_dflow_kernel")
    if not times:
        return None
    return 100.0 * counts.bound_seconds(rec["k3k4_bytes"]) / statistics.mean(
        times)
