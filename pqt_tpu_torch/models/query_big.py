"""The BIG query path: two-stage pairwise bin selection for large probe
budgets.

Port of pqt_tpu/models/query_big.py (the reference's queryBIGKNN /
getBIGBins2D, PerturbationProTree.cu:2839-3188, 3702-3778).  The p parts
pair up; per part-pair the best `n_intermediate` (l1,l2) x (l1,l2) cells
are kept by exact pair-sum order (stage 1), then the two pair lists are
merged by exact order of their sums (stage 2): the n_enum = min(
bin_enum_factor * max_bins, M * M) best combinations -- clamped by M * M,
not by the pair pipeline's enum_width -- are hashed to bin ids, looked up,
and compacted to max_bins non-empty bins.

On the card: every top-k is kernel A (stage 2 at SIFT1B_CONFIG's widths
keeps 32768 of each 65536-wide row, kernel A's merge mode), the counts and
CSR starts of the enumerated bins are kernel E, the compaction and the
candidate positions kernel B, and the line re-rank kernel C, which reads
each candidate's payload row once through its position; the perfect
variant reads the survivors' raw vectors and sums their squared distances
in one kernel (`gather_sqdist`).  As in the JAX package, the BIG path
uses no pair_occ.
Stage 2 needs p = 4 (two part-pairs); an odd p, or the perfect variant
without db.vectors, raises ValueError.  Both entry points are `graphed`
with the JAX package's static arguments (utils/graphs.py).
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import PQTDatabase
from pqt_tpu_torch.models.query import (QueryResult, _INF, _line_candidates,
                                        _local_bins,
                                        _mask_duplicate_candidates, _pad_k,
                                        _row_sqdist, _sorted_part_lists,
                                        _top_ids, _topk)
from pqt_tpu_torch.models.tree import PQTree
from pqt_tpu_torch.ops import binning
from pqt_tpu_torch.ops.cuda.gather import lut_gather
from pqt_tpu_torch.utils.graphs import graphed


def _pair_merge(cfg: PQTConfig, sorted_d2: torch.Tensor,
                sorted_codes: torch.Tensor, n_intermediate: int):
    """Stage 1: per part-pair, the n_intermediate smallest sums of the two
    parts' sorted lists (kernel A over the (L, L) grid, ties lowest index
    first).  sorted_d2, sorted_codes: (B, p, L).  Returns (pair_d2 (B, p/2,
    n_intermediate) ascending, pair_codes (B, p/2, n_intermediate, 2) the
    two parts' codes)."""
    B, p, L = sorted_d2.shape
    if p % 2:
        raise ValueError(f"the BIG path needs an even part count, not {p}")
    sums = sorted_d2[:, 0::2, :, None] + sorted_d2[:, 1::2, None, :]
    d, sel = _topk(sums.reshape(B, p // 2, L * L), n_intermediate)
    a_codes = torch.gather(sorted_codes[:, 0::2], 2, sel // L)
    b_codes = torch.gather(sorted_codes[:, 1::2], 2, sel % L)
    return d, torch.stack([a_codes, b_codes], dim=-1)


def _final_bins(cfg: PQTConfig, pair_d2: torch.Tensor,
                pair_codes: torch.Tensor, counts: torch.Tensor,
                bin_offset=None):
    """Stage 2: the n_enum smallest sums of the two pair lists (kernel A),
    their hashed bin ids, the counts (kernel E) and the first max_bins
    non-empty bins (kernel B).  pair_d2 (B, 2, M), pair_codes (B, 2, M, 2);
    `counts` may be a hash-range shard's table from global slot
    `bin_offset`.  Returns (bins (B, max_bins) local slot ids, counts)."""
    B, npair, M = pair_d2.shape
    if npair != 2:
        raise ValueError("the BIG path's final merge needs exactly two "
                         f"part-pairs (p = 4), not {npair}")
    sums = pair_d2[:, 0, :, None] + pair_d2[:, 1, None, :]    # (B, M, M)
    n_enum = min(cfg.bin_enum_factor * cfg.max_bins, M * M)
    _, sel = _topk(sums.reshape(B, M * M), n_enum)
    i_idx, j_idx = sel // M, sel % M
    codes4 = torch.stack(
        [torch.gather(pair_codes[:, 0, :, 0], 1, i_idx),
         torch.gather(pair_codes[:, 0, :, 1], 1, i_idx),
         torch.gather(pair_codes[:, 1, :, 0], 1, j_idx),
         torch.gather(pair_codes[:, 1, :, 1], 1, j_idx)], dim=-1)
    bin_ids, in_range = _local_bins(
        binning.hashed_bin_ids(codes4, cfg.part_radix, cfg.hash_size),
        counts.shape[0], bin_offset)
    bin_counts = lut_gather(counts, bin_ids.contiguous())
    if in_range is not None:
        bin_counts = torch.where(in_range, bin_counts, 0)
    return binning.compact_nonempty_bins(bin_ids, bin_counts, cfg.max_bins)


def query_big_core(cfg: PQTConfig, tree: PQTree, prefix, counts, payload,
                   queries, k: int, n_intermediate: int = 256,
                   bin_offset=None):
    """BIG query with line re-rank over the raw CSR tensors (prefix and
    counts the occupancy tables, or a shard's from global slot
    `bin_offset`).  Returns (ids (B, k') int32, line distances (B, k'),
    n_candidates (B,)), k' = min(k, max_candidates); -1 ids mark missing
    results."""
    queries = queries.to(torch.float32)
    sorted_d2, sorted_codes = _sorted_part_lists(cfg, tree, queries)
    pair_d2, pair_codes = _pair_merge(cfg, sorted_d2, sorted_codes,
                                      n_intermediate)
    bins, bin_counts = _final_bins(cfg, pair_d2, pair_codes, counts,
                                   bin_offset)
    positions, valid = binning.gather_candidates(
        lut_gather(prefix, bins.contiguous()), bin_counts,
        cfg.max_candidates, cfg.max_vec_per_bin)
    cand_ids, dists = _line_candidates(cfg, tree, payload, queries,
                                       torch.where(valid, positions, 0),
                                       valid)
    if cfg.dedup_candidates:
        dists = _mask_duplicate_candidates(cand_ids, valid, dists)
    return _top_ids(dists, cand_ids, min(k, cfg.max_candidates)) + (
        torch.sum(valid, dim=-1),)


@graphed(static_argnums=(0, 4, 5))
def query_big_knn(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                  queries: torch.Tensor, k: int,
                  n_intermediate: int = 256) -> QueryResult:
    """Batched BIG k-NN with line re-rank (queryBIGKNNRerank2's role);
    results past the candidate budget are padded with -1 / +inf."""
    ids, dists, n_cand = query_big_core(cfg, tree, db.prefix, db.counts,
                                        db.payload, queries, k,
                                        n_intermediate)
    ids, dists = _pad_k(ids, dists, k)
    return QueryResult(indices=ids, dists=dists, n_candidates=n_cand)


@graphed(static_argnums=(0, 4, 5, 6))
def query_big_knn_perfect(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                          queries: torch.Tensor, k: int,
                          refine_factor: int = 8,
                          n_intermediate: int = 256) -> QueryResult:
    """BIG query, then the exact re-rank of the k * refine_factor line
    survivors from db.vectors by id (queryBIGKNNRerankPerfect's role)."""
    if db.vectors is None:
        raise ValueError("query_big_knn_perfect needs db.vectors (raw "
                         "vectors by id)")
    queries = queries.to(torch.float32)
    k1 = min(k * refine_factor, cfg.max_candidates)
    stage1 = query_big_knn.__wrapped__(cfg, tree, db, queries, k1,
                                       n_intermediate)
    live = stage1.indices >= 0
    exact = torch.where(live, _row_sqdist(
        queries, db.vectors, torch.where(live, stage1.indices, 0)), _INF)
    dists, top_i = _topk(exact, min(k, k1))
    ids = torch.gather(stage1.indices, 1, top_i)
    ids, dists = _pad_k(ids, dists, k)
    return QueryResult(indices=ids, dists=dists,
                       n_candidates=stage1.n_candidates)
