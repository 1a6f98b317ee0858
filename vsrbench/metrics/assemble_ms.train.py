"""Milliseconds the loader's producer thread took, on average, to build one
batch (the program's counters ``loader.assemble_s`` over
``loader.assembled``). The counters run from the process's start, so the
batches of set-up count with the window's. Nothing off a card (a traced
sub-window with no device time)."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "train" or rec["trace"].busy_s <= 0:
        return None
    c = program_trace.counters()
    if not c or not c.get("loader.assembled"):
        return None
    return 1e3 * c["loader.assemble_s"] / c["loader.assembled"]
