"""Host milliseconds of one ``infer_sequence_batch`` call that starts with
the device queue empty, until it returns (before any sync): the median of
the sampled calls."""

import statistics


def read(rec):
    if rec.get("kind") != "infer" or not rec.get("dispatch_s"):
        return None
    return 1e3 * statistics.median(rec["dispatch_s"])
