"""The share of the traced build window in which no operation ran on the
device: 1 - busy_s / window, in percent, busy_s being the mean over the
cards the run used of each card's union of device events (on one card,
the union's seconds).  Layer: the device."""


def read(rec):
    t = rec.trace
    if rec.kind != "build" or t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
