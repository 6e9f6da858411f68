"""Host time a batch of the port's span `pqt.graph.key`: the graph
wrapper's key: from its entry through the arguments' binding, the key of
every tensor of the tree and the database and the static arguments, to
the lookup of the entry (utils/graphs.py). The mean duration of the span
inside the traced serving window, in microseconds (portbench/stages.py).
Layer: the entry points and graph cache."""

from portbench import stages


def read(rec):
    return stages.host_span_us(rec, "pqt.graph.key")
