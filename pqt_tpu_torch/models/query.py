"""Multi-probe query on the pair pipeline.

Port of the pair pipeline of pqt_tpu/models/query.py.  Per batch of
queries:

  1. L1, L2 and line distance tables (matrix products);
  2. per part-pair, the pair_top_m best (l1,l2) x (l1,l2) sums, ascending,
     with their partial bin-hash terms (`_pair_stage`);
  3. a 2D traversal over the two sorted pair lists composes the partial
     terms into bin ids (`_enumerate_bins_pair`);
  4. one row gather of the (start, end) extent table per enumerated bin, and
     the first max_bins non-empty bins (`_probe_bins`);
  5. capped candidate positions and one payload-row gather (`_collect_rows`);
  6. line re-rank from the payload rows (kernel C), and top-k (kernel A);
     or the exact re-rank from the raw vectors, by id.

With duplicate masking off (`dedup_candidates=False`, the main path),
every top-k and sort of a query is kernel A (ops/cuda/primitives.py, ties
lowest index first, like `lax.top_k`), and every prefix sum kernel B, so
bin ids, extents and candidate ids equal the JAX package's bit for bit
given the same distance tables.  Duplicate masking sorts the candidate
ids with `torch.sort` (ROADMAP.md queue 2).  Queries run on the device of the tree and
database tensors.  Bin-hash terms are uint32 values held in int64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import PQTDatabase
from pqt_tpu_torch.models.tree import (PQTree, level1_tables, level2_tables,
                                       line_tables)
from pqt_tpu_torch.ops import binning, distseq
from pqt_tpu_torch.ops.cuda.primitives import bitonic_topk, block_scan
from pqt_tpu_torch.ops.cuda.rerank import rerank_fused

_INF = float("inf")


def _duplicate_stats(cand_ids: torch.Tensor, valid: torch.Tensor):
    """(dup_mask, occurrences) over each row's candidate ids.

    dup_mask is True on every repeat after the first occurrence of an id;
    occurrences is the count of that id in the row (on every slot).
    Invalid slots get unique negative sentinels.
    """
    B, K = cand_ids.shape
    sentinels = -(torch.arange(K, dtype=cand_ids.dtype,
                               device=cand_ids.device) + 1)
    uid = torch.where(valid, cand_ids, sentinels[None, :])
    sorted_uid, order = torch.sort(uid, dim=-1, stable=True)
    new_run = torch.ones_like(valid)
    new_run[:, 1:] = sorted_uid[:, 1:] != sorted_uid[:, :-1]
    run_id = (block_scan(new_run.to(torch.int32)) - 1).to(torch.int64)
    run_len = torch.zeros((B, K), dtype=torch.int32, device=cand_ids.device)
    run_len.scatter_add_(1, run_id, torch.ones_like(run_len))
    occ_sorted = torch.gather(run_len, 1, run_id)
    dup = torch.empty_like(valid).scatter_(1, order, ~new_run)
    occ = torch.empty_like(run_len).scatter_(1, order, occ_sorted)
    return dup, occ


def _mask_duplicate_candidates(cand_ids, valid, dists):
    """Set the distance of repeated candidate ids to +inf."""
    dup, _ = _duplicate_stats(cand_ids, valid)
    return torch.where(dup, _INF, dists)


class QueryResult(NamedTuple):
    indices: torch.Tensor       # (B, k) int32 database vector ids, -1 = none
    dists: torch.Tensor         # (B, k) float32 (approximate or exact)
    n_candidates: torch.Tensor  # (B,) candidates actually re-ranked


def _require_pair(cfg: PQTConfig) -> None:
    if not cfg.pair_pipeline_enabled:
        raise NotImplementedError(
            "pqt_tpu_torch serves the pair pipeline (pipeline='pair', p in "
            "(2, 4)); the 'parts' pipeline comes with the slice 'the other "
            "query pipelines' (ROADMAP.md queue 1)")
    if cfg.gather_mode != "rows":
        raise NotImplementedError(
            "gather_mode='slabs' comes with the slice 'the other query "
            "pipelines' (ROADMAP.md queue 1)")


def _part_hash_weights(cfg: PQTConfig):
    """((p,) per-part weights w with bin pre-image sum_j w_j * code_j,
    exact): mixed radix when the unhashed space fits the table, the mixing
    multipliers otherwise (ops/binning.py)."""
    r = cfg.part_radix
    if binning.is_exact(r, cfg.p, cfg.hash_size):
        return [r ** (cfg.p - 1 - j) for j in range(cfg.p)], True
    mix = binning.MIX_MULTIPLIERS
    return [mix[j % len(mix)] for j in range(cfg.p)], False


def _finalize_bin_ids(cfg: PQTConfig, acc: torch.Tensor,
                      exact: bool) -> torch.Tensor:
    """uint32 pre-image (int64) -> int32 bin slot id."""
    if exact:
        return acc.to(torch.int32)
    return binning.finalize_hash(acc, cfg.hash_size)


def _topk(x: torch.Tensor, k: int):
    """Kernel A over the last axis of any-rank x: (values, int64 indices)."""
    lead = x.shape[:-1]
    v, i = bitonic_topk(x.reshape(-1, x.shape[-1]).contiguous(), k)
    return v.reshape(lead + (k,)), i.to(torch.int64).reshape(lead + (k,))


def _pair_stage(cfg: PQTConfig, tree: PQTree, queries: torch.Tensor,
                pair_occ: Optional[torch.Tensor] = None):
    """Per part-pair, the pair_top_m best (l1,l2) x (l1,l2) combinations.

    Returns (d_pairs (B, p/2, M) ascending sums, h_pairs (B, p/2, M) int64
    uint32 partial bin terms, exact).  With `pair_occ`, pairs absent from
    the database get +inf and sort behind every live pair.
    """
    W = cfg.k1_query
    d1 = level1_tables(cfg, tree, queries)               # (B, p, c1)
    d2 = level2_tables(cfg, tree, queries)               # (B, p, c1, c2)
    _, l1_idx = _topk(d1, W)                             # (B, p, W)
    B, p = d1.shape[:2]
    cand_d2 = torch.gather(d2, 2, l1_idx[..., None].expand(B, p, W, cfg.c2))
    L = W * cfg.c2
    flat_d2 = cand_d2.reshape(B, p, L)
    codes = (l1_idx[..., None] * cfg.c2 +
             torch.arange(cfg.c2, device=queries.device)).reshape(B, p, L)
    weights, exact = _part_hash_weights(cfg)
    M = min(cfg.pair_top_m, L * L)
    n_pairs = p // 2
    a, b = slice(0, p, 2), slice(1, p, 2)                # parts 2j, 2j+1
    s = flat_d2[:, a, :, None] + flat_d2[:, b, None, :]  # (B, n_pairs, L, L)
    d, idx = _topk(s.reshape(B, n_pairs, L * L), M)      # both pairs at once
    ca = torch.gather(codes[:, a], 2, idx // L)
    cb = torch.gather(codes[:, b], 2, idx % L)
    h = torch.stack([ca[:, j] * weights[2 * j] + cb[:, j] * weights[2 * j + 1]
                     for j in range(n_pairs)], dim=1) & 0xFFFFFFFF
    if pair_occ is not None and cfg.pair_filter_enabled:
        r = cfg.part_radix
        rows = torch.arange(n_pairs, device=queries.device)[:, None]
        occ = pair_occ[rows, ca * r + cb]                # (B, n_pairs, M)
        d = torch.where(occ > 0, d, _INF)
        # stable re-sort: dead pairs to the tail, live order kept
        d, perm = _topk(d, M)
        h = torch.gather(h, 2, perm)
    return d, h, exact


@functools.lru_cache(maxsize=16)
def _pair_sequence_on(m: int, length: int, device: torch.device):
    """distseq.pair_sequence as an int64 tensor on `device`, uploaded once
    (a host-to-device copy per batch would stall the host on the card)."""
    return torch.tensor(distseq.pair_sequence(m, length), dtype=torch.int64,
                        device=device)


def _enumerate_bins_pair(cfg: PQTConfig, h_pairs: torch.Tensor,
                         exact: bool) -> torch.Tensor:
    """2D traversal over the two sorted pair lists -> (B, E) bin slot ids.

    h_pairs: (B, n_pairs, M) partial terms, ascending by pair distance.
    Bin e composes pair ranks pair_sequence(M, E)[e] by adding the two
    partial terms mod 2^32 (the mixing hash is a sum over parts).
    """
    B, n_pairs, M = h_pairs.shape
    E = min(cfg.effective_enum_width, M * M if n_pairs == 2 else M)
    if n_pairs == 1:
        return _finalize_bin_ids(cfg, h_pairs[:, 0, :E], exact)
    if n_pairs != 2:
        raise ValueError("the pair pipeline supports p in (2, 4)")
    seq = _pair_sequence_on(M, E, h_pairs.device)
    acc = (h_pairs[:, 0, seq[:, 0]] + h_pairs[:, 1, seq[:, 1]]) & 0xFFFFFFFF
    return _finalize_bin_ids(cfg, acc, exact)


def _probe_bins(cfg: PQTConfig, bins: torch.Tensor, prefix2: torch.Tensor):
    """One extent-row gather per enumerated bin, then the first max_bins
    non-empty bins in enumeration order: (start, count) (B, nb) int32."""
    ext = prefix2[bins.to(torch.int64)]                  # (B, E, 2)
    start = ext[..., 0]
    cnt = ext[..., 1] - ext[..., 0]
    return binning.compact_nonempty_bins(start, cnt,
                                         min(cfg.max_bins, bins.shape[1]))


def _collect_rows(cfg: PQTConfig, payload: torch.Tensor, start, cnt):
    """Candidate payload rows from the probed bins' extents (rows mode).

    Returns (rows (B, K, W), valid (B, K), positions (B, K) int64 CSR row of
    each candidate, 0 where invalid), K = max_candidates.
    """
    positions, valid = binning.gather_candidates(
        start, cnt, cfg.max_candidates, cfg.max_vec_per_bin)
    safe_pos = torch.where(valid, positions, 0).to(torch.int64)
    return payload[safe_pos], valid, safe_pos


def query_core_pair(cfg: PQTConfig, tree: PQTree, prefix2, payload,
                    queries, k: int, pair_occ=None,
                    want_candidates: bool = False):
    """Pair-pipeline query over the raw CSR tensors.

    Returns (ids (B, k) int32, line distances (B, k), n_candidates (B,));
    -1 ids mark missing results.  With want_candidates=True, returns the
    whole candidate set before top-k instead: (cand_ids (B, K), dists
    (B, K) +inf where invalid, n_candidates, positions (B, K)).
    """
    _require_pair(cfg)
    queries = queries.to(torch.float32)
    _, h_pairs, exact = _pair_stage(cfg, tree, queries, pair_occ)
    bins = _enumerate_bins_pair(cfg, h_pairs, exact)
    start, cnt = _probe_bins(cfg, bins, prefix2)
    rows, valid, positions = _collect_rows(cfg, payload, start, cnt)
    cand_ids = rows[..., 0]
    q_line = line_tables(cfg, tree, queries).contiguous()   # (B, lp, c1)
    dists = rerank_fused(rows, q_line, cfg.payload_is_compact)
    dists = torch.where(valid, dists, _INF)
    if cfg.dedup_candidates:
        dists = _mask_duplicate_candidates(cand_ids, valid, dists)
    n_cand = torch.sum(valid, dim=-1)
    if want_candidates:
        return cand_ids, dists, n_cand, positions
    top_d, top_i = _topk(dists, min(k, dists.shape[-1]))
    top_ids = torch.gather(cand_ids, 1, top_i)
    return torch.where(torch.isfinite(top_d), top_ids, -1), top_d, n_cand


def _pad_k(ids, dists, k):
    pad = k - ids.shape[1]
    if pad > 0:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        dists = torch.nn.functional.pad(dists, (0, pad), value=_INF)
    return ids, dists


def _exact_top(queries, vectors, cand_ids, valid, k):
    """Exact squared distances of the candidates (by original id) and their
    top-k: (ids, dists)."""
    safe = torch.where(valid, cand_ids, 0).to(torch.int64)
    diff = vectors[safe].to(torch.float32) - queries[:, None, :]
    exact = torch.where(valid, torch.sum(diff * diff, dim=-1), _INF)
    top_d, top_i = _topk(exact, min(k, exact.shape[-1]))
    ids = torch.gather(cand_ids, 1, top_i)
    return torch.where(torch.isfinite(top_d), ids, -1), top_d


def _require_vectors(db: PQTDatabase, what: str) -> None:
    if db.vectors is None:
        if db.vectors_csr is not None:
            raise NotImplementedError(
                f"{what} over a database that holds only vectors_csr (an "
                "out-of-core build) comes with the slice 'the other query "
                "pipelines' (query_core_exact, ROADMAP.md queue 1)")
        raise ValueError(f"{what} needs raw vectors: build with "
                         "keep_vectors=True")


def query_knn(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
              queries: torch.Tensor, k: int,
              exact_rerank: bool = False) -> QueryResult:
    """Batched approximate k-NN: queries (B, dim) -> ids sorted by the line
    (or, with exact_rerank, exact) distance."""
    queries = queries.to(torch.float32)
    if exact_rerank:
        _require_vectors(db, "exact re-rank")
        cand_ids, line_d, _, _ = query_core_pair(
            cfg, tree, db.prefix2, db.payload, queries, k,
            pair_occ=db.pair_occ, want_candidates=True)
        valid = torch.isfinite(line_d)      # duplicates already masked
        ids, dists = _exact_top(queries, db.vectors, cand_ids, valid, k)
        n_cand = torch.sum(valid, dim=-1)
    else:
        ids, dists, n_cand = query_core_pair(
            cfg, tree, db.prefix2, db.payload, queries, k,
            pair_occ=db.pair_occ)
    ids, dists = _pad_k(ids, dists, k)
    return QueryResult(indices=ids, dists=dists, n_candidates=n_cand)


def query_candidates(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                     queries: torch.Tensor):
    """The gathered candidate set before any re-rank: (cand_ids (B, K)
    int32, valid (B, K) bool), for candidate recall."""
    cand_ids, line_d, _, _ = query_core_pair(
        cfg, tree, db.prefix2, db.payload, queries.to(torch.float32), 0,
        pair_occ=db.pair_occ, want_candidates=True)
    return cand_ids, torch.isfinite(line_d)


def query_knn_refine(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                     queries: torch.Tensor, k: int, refine_factor: int = 8,
                     k_line: Optional[int] = None) -> QueryResult:
    """Two stages: line re-rank to k * refine_factor (or k_line) candidates,
    then exact re-rank of those from the raw vectors."""
    _require_vectors(db, "query_knn_refine")
    queries = queries.to(torch.float32)
    stage1 = query_knn(cfg, tree, db, queries, k_line or k * refine_factor)
    ids, dists = _exact_top(queries, db.vectors, stage1.indices,
                            stage1.indices >= 0, k)
    ids, dists = _pad_k(ids, dists, k)
    return QueryResult(indices=ids, dists=dists,
                       n_candidates=stage1.n_candidates)
