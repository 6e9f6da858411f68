"""Kernel time a query: the summed durations of every kernel of the
traced serving window (copies left out) over the queries answered in it,
in microseconds.  Layer: the query stages (distance tables, pair stage,
enumeration, probe, gather, re-rank)."""


def read(rec):
    t = rec.trace
    if rec.kind != "serve" or t is None or not rec.queries:
        return None
    kernels = t.kernels()
    if not kernels:
        return None
    return sum(e - s for _, s, e in kernels) / rec.queries
