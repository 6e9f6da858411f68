"""Device time a query of the query stage `query.tables`: the distance
tables and the L1 top-k (models/query.py _part_candidates). The summed
durations of the device operations that start between the stage's mark
and the next one, over the complete marked calls of the traced serving
window (portbench/stages.py), over their queries, in microseconds.
Layer: the query stages."""

from portbench import stages


def read(rec):
    return stages.per_query(rec, "query.tables")
