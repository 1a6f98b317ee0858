"""Host milliseconds the window's loop waited, on average, for the
loader's next batch."""

import statistics


def read(rec):
    if rec.get("kind") != "train" or not rec.get("batch_wait_s"):
        return None
    return 1e3 * statistics.mean(rec["batch_wait_s"])
