"""The exact re-rank's share of its roofline: the least time of its work
at the card's published HBM rate (every valid candidate's raw row and id
read once, its distance written once, each query read once; the
candidates counted from the answers' n_candidates) over the time of the
kernel that computes the distances, in percent.  Layer: the exact
re-rank (query_knn's exact path -> gather_sqdist, csrc/sqdist.cu)."""

from portbench import yardstick

KERNELS = ("gather_sqdist_kernel",)


def read(rec):
    t = rec.trace
    if rec.kind != "serve" or t is None or not rec.valid_candidates:
        return None
    busy = sum(e - s for name, s, e in t.kernels()
               if any(k in name for k in KERNELS)) / 1e6
    if busy <= 0:
        return None
    least = yardstick.exact_rerank_bytes(
        rec.valid_candidates, rec.queries, rec.pqt["dim"],
        rec.pqt["dim"]) / yardstick.PEAK_BYTES_PER_S
    return 100.0 * least / busy
