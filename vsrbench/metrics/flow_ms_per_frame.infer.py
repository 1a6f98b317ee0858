"""Device milliseconds per HR frame of BasicVSR++'s SPyNet: over the
program's ``tecogan.infer.flow`` spans of the traced calls (one a call,
both directions over every frame pair), the device time between the two
marks each span records on its stream, per frame the calls made."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "infer":
        return None
    tr = rec["trace"]
    if tr.busy_s <= 0 or not tr.units:
        return None
    flow = program_trace.spans_in(tr, "infer.flow")
    if not flow:
        return None
    ms = [s.device_ms() for s in flow]
    if None in ms:
        return None
    return sum(ms) / tr.units
