"""Device milliseconds per HR frame: the profiler's device time over the
traced calls (summed over every device operation), per frame they made."""


def read(rec):
    if rec.get("kind") != "infer":
        return None
    tr = rec["trace"]
    total = sum(e - s for _, s, e in tr.kernels) / 1e9
    if total <= 0 or not tr.units:
        return None
    return 1e3 * total / tr.units
