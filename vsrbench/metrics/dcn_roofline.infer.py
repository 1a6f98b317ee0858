"""The DCN's share of its roofline: the least time the card could take for
the traced calls' DCNs (``vsrbench/counts_basicvsrpp.py``: each frame
step's input, raw offset and mask channels, flows and weight read once and
its output written once at 3.35 TB/s, or its product's FLOPs at 989
TFLOP/s, whichever is longer) over the device time between the marks of
the program's ``tecogan.infer.dcn`` spans, so it reads the same work
whatever implements the DCN."""

from vsrbench import counts_basicvsrpp, program_trace


def read(rec):
    if rec.get("kind") != "infer" or "dcn_bytes" not in rec:
        return None
    tr = rec["trace"]
    if tr.busy_s <= 0:
        return None
    dcn = program_trace.spans_in(tr, "infer.dcn")
    if not dcn:
        return None
    ms = [s.device_ms() for s in dcn]
    if None in ms or sum(ms) <= 0:
        return None
    bound = counts_basicvsrpp.bound_seconds(rec["dcn_bytes"],
                                            rec["dcn_flops"])
    return 100.0 * len(dcn) * bound / (sum(ms) / 1e3)
