"""Batched squared L2 distance tables, the plain version of kernel P (the
build's part codes, the argmin of the level-2 tables), the exact
brute-force oracle, and the brute-force baseline.

Port of pqt_tpu/ops/distance.py.  Every table is one matrix product plus
norms, ||x - c||^2 = ||x||^2 + ||c||^2 - 2 <x, c>, in full float32: the
identity loses too much in TF32 (k-means splits and ground truth at SIFT
scale, distances ~1e5), which is why the package turns TF32 off at import.
The per-part norms of the query side are segment sums of squares (kernel D,
`segmented_reduce` in square mode: x read once, squared on load, as XLA
fuses `jnp.sum(x ** 2, -1)` in the JAX package).
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops.cuda.primitives import bitonic_topk, segmented_reduce


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(n, d) x (k, d) -> (n, k) squared distances, float32."""
    x = x.to(torch.float32)
    c = c.to(torch.float32)
    dot = x @ c.T
    xn = torch.sum(x * x, dim=-1, keepdim=True)
    cn = torch.sum(c * c, dim=-1)
    return torch.clamp_min(xn + cn[None, :] - 2.0 * dot, 0.0)


def part_norms(x: torch.Tensor, codebook: torch.Tensor):
    """The norms of `part_sqdist_tables`: x (n, p*vl), codebook (p, k, vl)
    -> (x float32 contiguous, codebook float32, cn (p, k) the centroids'
    squared norms, xn (n, p) the rows' per-part ones, kernel D's)."""
    d = x.shape[1]
    p, _, vl = codebook.shape
    if d != p * vl:
        raise ValueError(f"dim {d} != p*vl = {p}*{vl}")
    x = x.to(torch.float32).contiguous()
    cb = codebook.to(torch.float32)
    return (x, cb, torch.sum(cb * cb, dim=-1),
            segmented_reduce(x, p, square=True))


def _tables(x, cb, cn, xn) -> torch.Tensor:
    p, _, vl = cb.shape
    dot = torch.einsum("npv,pkv->npk", x.reshape(x.shape[0], p, vl), cb)
    return torch.clamp_min(xn[:, :, None] + cn[None, :, :] - 2.0 * dot, 0.0)


def part_sqdist_tables(x: torch.Tensor,
                       codebook: torch.Tensor) -> torch.Tensor:
    """Per-part squared distances: x (n, p*vl), codebook (p, k, vl) ->
    (n, p, k)."""
    return _tables(*part_norms(x, codebook))


def part_codes_plain(x: torch.Tensor, codebook: torch.Tensor,
                     cn: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel P (ops/cuda/partcodes.py): per (row,
    part) the index of the least of `part_sqdist_tables`' distances, the
    first one, a NaN the least (torch.argmin).  x (n, p*vl), codebook (p,
    k, vl), cn (p, k) and xn (n, p) as `part_norms` gives them -> (n, p)
    int64."""
    return torch.argmin(_tables(x, codebook, cn, xn), dim=-1)


def subpart_sqdist_terms(x: torch.Tensor, centroids: torch.Tensor,
                         line_parts: int):
    """The three terms of `subpart_sqdist_tables` for x (n, d) and the L1
    centroids (c1, d): dot (n, line_parts, c1) the segments' dot products,
    as the batched matmul leaves them (strides (c1, n * c1, 1)); xn (n,
    line_parts) the rows' segment norms (kernel D); cn (c1, line_parts) the
    centroids' ones."""
    n, d = x.shape
    c1 = centroids.shape[0]
    lvl = d // line_parts
    x = x.to(torch.float32).contiguous()
    xp = x.reshape(n, line_parts, lvl)
    cp = centroids.to(torch.float32).reshape(c1, line_parts, lvl)
    dot = torch.einsum("nlv,clv->nlc", xp, cp)
    xn = segmented_reduce(x, line_parts, square=True)
    cn = torch.sum(cp * cp, dim=-1)
    return dot, xn, cn


def subpart_sqdist_from_terms(dot: torch.Tensor, xn: torch.Tensor,
                              cn: torch.Tensor) -> torch.Tensor:
    """The distances of `subpart_sqdist_terms`' terms: (n, line_parts,
    c1)."""
    return torch.clamp_min(xn[:, :, None] + cn.T[None, :, :] - 2.0 * dot, 0.0)


def subpart_sqdist_tables(x: torch.Tensor, centroids: torch.Tensor,
                          line_parts: int) -> torch.Tensor:
    """Distances between line-part segments of x (n, d) and of the full
    L1 centroids (c1, d): (n, line_parts, c1)."""
    return subpart_sqdist_from_terms(
        *subpart_sqdist_terms(x, centroids, line_parts))


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


def brute_force_knn_fast(queries: torch.Tensor, db: torch.Tensor, k: int):
    """Throughput-oriented brute force, the same-card baseline of a serving
    path: every distance in full float32 (`pairwise_sqdist`; the package
    keeps TF32 off), then kernel A's top-k of each row.

    The JAX package's version selects with `lax.approx_max_k` at a recall
    target; on the CPU that is exact, and so is kernel A, so the port
    takes no recall target: its k are the k smallest float32 distances,
    ties lowest index first.  Returns (dists (q, k) float32 ascending,
    indices (q, k) int32).
    """
    return bitonic_topk(pairwise_sqdist(queries, db), k)
