"""Device milliseconds per HR frame of BasicVSR++'s second-order
alignment: over the program's ``tecogan.infer.align`` spans of the traced
calls (one per aligned frame step of a branch: its warps, conv_offset and
the DCN), the device time between the two marks each span records on its
stream, per frame the calls made."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "infer":
        return None
    tr = rec["trace"]
    if tr.busy_s <= 0 or not tr.units:
        return None
    align = program_trace.spans_in(tr, "infer.align")
    if not align:
        return None
    ms = [s.device_ms() for s in align]
    if None in ms:
        return None
    return sum(ms) / tr.units
