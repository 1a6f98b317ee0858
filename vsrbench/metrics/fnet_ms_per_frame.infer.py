"""Device milliseconds per HR frame of FNet: over the program's
``tecogan.infer.fnet`` spans of the traced calls, the device time between
the two marks each span records on its stream (FNet's kernels over the
chunk's frame pairs, with any device idle between them), per frame the
calls made."""

from vsrbench import program_trace


def read(rec):
    if rec.get("kind") != "infer":
        return None
    tr = rec["trace"]
    if tr.busy_s <= 0 or not tr.units:
        return None
    fnet = program_trace.spans_in(tr, "infer.fnet")
    if not fnet:
        return None
    ms = [s.device_ms() for s in fnet]
    if None in ms:
        return None
    return sum(ms) / tr.units
