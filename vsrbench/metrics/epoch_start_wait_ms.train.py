"""Milliseconds the training loop waited, on average, for an epoch's first
batch: the loader's restart (the program's counters
``loader.epoch_start_wait_s`` over ``loader.epoch_starts``). The counters
run from the process's start, so the epochs of set-up count with the
window's. Nothing off a card (a traced sub-window with no device time)."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "train" or rec["trace"].busy_s <= 0:
        return None
    c = program_trace.counters()
    if not c or not c.get("loader.epoch_starts"):
        return None
    return 1e3 * c["loader.epoch_start_wait_s"] / c["loader.epoch_starts"]
