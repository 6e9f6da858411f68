"""Batched squared L2 distance tables, and the exact brute-force oracle.

Port of pqt_tpu/ops/distance.py.  Every table is one matrix product plus
norms, ||x - c||^2 = ||x||^2 + ||c||^2 - 2 <x, c>, in full float32: the
identity loses too much in TF32 (k-means splits and ground truth at SIFT
scale, distances ~1e5), which is why the package turns TF32 off at import.
The per-part norms of the query side are segment sums (kernel D,
`segmented_reduce`).
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops.cuda.primitives import segmented_reduce


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) squared distances, float32."""
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    dot = x @ c.T
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    cn = torch.sum(c * c, dim=-1)
    return torch.clamp_min(xn + cn[None, :] - 2.0 * dot, 0.0)


def part_sqdist_tables(x: torch.Tensor,
                       codebook: torch.Tensor) -> torch.Tensor:
    """Per-part squared distances: x (n, p*vl), codebook (p, k, vl) ->
    (n, p, k)."""
    n, d = x.shape
    p, k, vl = codebook.shape
    if d != p * vl:
        raise ValueError(f"dim {d} != p*vl = {p}*{vl}")
    x = x.to(torch.float32)
    xp = x.reshape(n, p, vl)
    cb = codebook.to(torch.float32)
    dot = torch.einsum("npv,pkv->npk", xp, cb)
    xn = segmented_reduce(x * x, p)
    cn = torch.sum(cb * cb, dim=-1)
    return torch.clamp_min(xn[:, :, None] + cn[None, :, :] - 2.0 * dot, 0.0)


def subpart_sqdist_tables(x: torch.Tensor, centroids: torch.Tensor,
                          line_parts: int) -> torch.Tensor:
    """Distances between line-part segments of x (n, d) and of the full
    L1 centroids (c1, d): (n, line_parts, c1)."""
    n, d = x.shape
    c1 = centroids.shape[0]
    lvl = d // line_parts
    x = x.to(torch.float32)
    xp = x.reshape(n, line_parts, lvl)
    cp = centroids.to(torch.float32).reshape(c1, line_parts, lvl)
    dot = torch.einsum("nlv,clv->nlc", xp, cp)
    xn = segmented_reduce(x * x, line_parts)
    cn = torch.sum(cp * cp, dim=-1)
    return torch.clamp_min(xn[:, :, None] + cn.T[None, :, :] - 2.0 * dot, 0.0)


def centroid_pair_sqdist(centroids: torch.Tensor,
                         line_parts: int) -> torch.Tensor:
    """Per-line-part squared distances between every pair of L1 centroids:
    (c1, d) -> (line_parts, c1, c1)."""
    c1, d = centroids.shape
    cp = centroids.to(torch.float32).reshape(c1, line_parts, d // line_parts)
    diff = cp[:, None, :, :] - cp[None, :, :, :]       # (c1, c1, lp, lvl)
    return torch.sum(diff * diff, dim=-1).permute(2, 0, 1).contiguous()


def brute_force_knn(queries: torch.Tensor, db: torch.Tensor, k: int,
                    batch: int = 1024, db_chunk: int = 262144):
    """Exact k-NN in float64: the correctness oracle, not a serving path.

    The database streams in chunks with a running top-k merge, so no
    (queries x n) matrix is materialized.  Selection uses torch.topk: the
    oracle is deliberately independent of the package's own kernels.
    Returns (dists (q, k) float64, indices (q, k) int64), ascending.
    """
    n = db.shape[0]
    k = min(k, n)
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], batch):
        q = queries[s:s + batch].to(torch.float64)
        qn = torch.sum(q * q, dim=-1, keepdim=True)
        best_d = torch.full((q.shape[0], 0), float("inf"), dtype=torch.float64,
                            device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                             device=q.device)
        for c in range(0, n, db_chunk):
            blk = db[c:c + db_chunk].to(device=q.device, dtype=torch.float64)
            d = qn + torch.sum(blk * blk, dim=-1)[None, :] - 2.0 * (q @ blk.T)
            kc = min(k, d.shape[1])
            vd, vi = torch.topk(d, kc, dim=1, largest=False)
            cat_d = torch.cat([best_d, vd], dim=1)
            cat_i = torch.cat([best_i, vi + c], dim=1)
            best_d, sel = torch.topk(cat_d, min(k, cat_d.shape[1]), dim=1,
                                     largest=False)
            best_i = torch.gather(cat_i, 1, sel)
        out_d.append(best_d)
        out_i.append(best_i)
    return torch.cat(out_d), torch.cat(out_i)
