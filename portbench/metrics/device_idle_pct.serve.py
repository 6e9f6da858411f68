"""The share of the traced serving window in which no operation ran on
the device: 1 - (union of the device events' intervals) / window, in
percent.  Layer: the device."""


def read(rec):
    t = rec.trace
    if rec.kind != "serve" or t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
