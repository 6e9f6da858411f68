"""Idle inside a call: the share, in percent, of the complete marked
calls' spans (`query.tables`'s mark to `query.end`'s, portbench/stages.py)
in which no device operation ran; for a replayed call, the gaps between
the graph's nodes.  What remains of device_idle_pct.serve lies between
calls.  Layer: the device."""

from portbench import stages


def read(rec):
    return stages.idle_share(rec)
