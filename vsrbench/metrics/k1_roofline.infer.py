"""K1's share of its roofline: the least time the card could take at the
call's shape (the image and the flow read once, the output written once, at
the H100's 3.35 TB/s) over K1's mean device time in the trace."""

import statistics

from vsrbench import counts


def read(rec):
    if rec.get("kind") != "infer":
        return None
    times = rec["trace"].kernel_times("warp_planes_kernel")
    if not times:
        return None
    return 100.0 * counts.bound_seconds(rec["k1_bytes"]) / statistics.mean(
        times)
