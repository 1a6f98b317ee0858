"""Device idle milliseconds per training step inside the program's
``tecogan.train.step`` spans of the traced sub-window: the time the card
waits on the step's own host pace (TecoGAN's vote included), apart from
the loop's batch waits and copies between steps."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "train":
        return None
    tr = rec["trace"]
    if tr.busy_s <= 0:
        return None
    steps = program_trace.spans_in(tr, "train.step")
    if not steps:
        return None
    idle = program_trace.idle_inside_s(
        tr, [(s.start_ns, s.end_ns) for s in steps])
    return 1e3 * idle / len(steps)
