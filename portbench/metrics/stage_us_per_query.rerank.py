"""Device time a query of the query stage `query.rerank`: the exact re-rank
or the line top-k, then the answers' padding (_exact_top, _pad_k). The
summed durations of the device operations that start between the stage's
mark and the next one, over the complete marked calls of the traced
serving window (portbench/stages.py), over their queries, in
microseconds. Layer: the query stages."""

from portbench import stages


def read(rec):
    return stages.per_query(rec, "query.rerank")
