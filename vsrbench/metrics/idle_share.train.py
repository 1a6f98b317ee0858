"""The share of the traced sub-window of the training loop with no device
operation running."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    tr = rec["trace"]
    if tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
