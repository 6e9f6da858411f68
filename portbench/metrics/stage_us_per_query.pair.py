"""Device time a query of the query stage `query.pair`: the rest of the
pair stage: the pair sums and kernel A's pair select (_pair_stage). The
summed durations of the device operations that start between the stage's
mark and the next one, over the complete marked calls of the traced
serving window (portbench/stages.py), over their queries, in
microseconds. Layer: the query stages."""

from portbench import stages


def read(rec):
    return stages.per_query(rec, "query.pair")
