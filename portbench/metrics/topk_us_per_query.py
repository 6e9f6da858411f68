"""Kernel A's time a query: the summed durations of the kernels of
csrc/topk.cu (every route: the sort, the select, the merge passes, the
cluster route) in the traced serving window over its queries, in
microseconds.  Layer: the pair stage and the final top-k."""

KERNELS = ("bitonic_sort_kernel", "radix_select_kernel", "run_sort_kernel",
           "cluster_topk_kernel", "merge_pass_kernel")


def read(rec):
    t = rec.trace
    if rec.kind != "serve" or t is None or not rec.queries:
        return None
    mine = [e - s for name, s, e in t.kernels()
            if any(k in name for k in KERNELS)]
    if not mine:
        return None
    return sum(mine) / rec.queries
