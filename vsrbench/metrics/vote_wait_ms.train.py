"""Host milliseconds per TecoGAN step inside the program's
``tecogan.train.vote`` spans of the traced sub-window: the vote's read of
the distance back from the card, which waits for the card to reach it."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "train":
        return None
    tr = rec["trace"]
    if tr.busy_s <= 0:
        return None
    votes = program_trace.spans_in(tr, "train.vote")
    steps = program_trace.spans_in(tr, "train.step")
    if not votes or not steps:
        return None
    return 1e3 * sum(s.end_ns - s.start_ns for s in votes) / 1e9 / len(steps)
