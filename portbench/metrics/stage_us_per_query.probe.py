"""Device time a query of the query stage `query.probe`: the bins'
enumeration and probe: H's extent rows and B's compaction
(_enumerate_bins_pair, _probe_bins). The summed durations of the device
operations that start between the stage's mark and the next one, over
the complete marked calls of the traced serving window
(portbench/stages.py), over their queries, in microseconds. Layer: the
query stages."""

from portbench import stages


def read(rec):
    return stages.per_query(rec, "query.probe")
