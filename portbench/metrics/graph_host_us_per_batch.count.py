"""Host time a batch of the port's span `pqt.graph.count`: the launch
counters a replay adds to the kernel wrappers (utils/graphs.py
CapturedQuery.replay). The mean duration of the span inside the traced
serving window, in microseconds (portbench/stages.py). Layer: the entry
points and graph cache."""

from portbench import stages


def read(rec):
    return stages.host_span_us(rec, "pqt.graph.count")
