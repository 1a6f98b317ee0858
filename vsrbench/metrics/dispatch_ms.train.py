"""Host milliseconds of one training-step call that starts with the device
queue empty, until it returns: the median of the sampled steps. TecoGAN's
step waits inside itself for the vote's host read, so its figure holds the
device time before the vote."""

import statistics


def read(rec):
    if rec.get("kind") != "train" or not rec.get("dispatch_s"):
        return None
    return 1e3 * statistics.median(rec["dispatch_s"])
