"""Host time of the port's entry point a batch: the benchmark's own span
around `query_knn` (from the call to its return, before the results are
copied to the host, which waits for the device), mean over the traced
window, in microseconds.  Layer: the entry points and the graph cache
(models/query.py over utils/graphs.py)."""


def read(rec):
    if rec.kind != "serve" or not rec.host_s:
        return None
    return sum(rec.host_s) / len(rec.host_s) * 1e6
