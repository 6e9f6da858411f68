"""Multi-probe query: the pair pipeline and the parts pipeline.

Port of pqt_tpu/models/query.py.  Per batch of queries:

  1. L1, L2 and line distance tables (matrix products; the per-part norms
     are kernel D);
  2. the probed bins, by either pipeline:
     * pair (`pipeline="pair"`, p in (2, 4)): per part-pair the pair_top_m
       best (l1,l2) x (l1,l2) sums with their partial bin-hash terms
       (`_pair_stage`), a 2D traversal composing them into bin ids
       (`_enumerate_bins_pair`), and one extent-row gather per bin with
       the first max_bins non-empty ones kept (`_probe_bins`);
     * parts (any other shape, or `pipeline="parts"`): per part the
       k1_query*c2 candidate codes sorted by distance (`_sorted_part_lists`),
       a p-dimensional traversal over their ranks to bin ids, optionally
       pruned by the pair-occupancy table, then the occupancy lookup and
       compaction (`_enumerate_bins`), and the CSR starts of the kept bins;
  3. candidate CSR positions, capped per row or as slab windows
     (`_candidate_positions`);
  4. line re-rank (kernel C: each candidate's payload row read once
     through its position, its id and line distance written), and top-k
     (kernel A); or the exact re-rank from the raw vectors: by id, or, for an
     out-of-core database, from `vectors_csr` by CSR position
     (`query_core_exact`, and the refine's second stage), each candidate's
     row read once through its position and its squared distance written
     by one kernel (`gather_sqdist`, kernels H and D fused).

The cores take `bin_offset` as their JAX signatures do: their tables may be
one hash-range shard's, starting at that global slot.

With duplicate masking off (`dedup_candidates=False`, the main path),
every top-k and sort of a query is kernel A (ops/cuda/primitives.py, ties
lowest index first, like `lax.top_k` and a stable sort), every prefix sum
kernel B, every table lookup kernel E (`lut_gather`), every gather of
extent rows, and of the payload rows whose ids the exact re-rank reads,
kernel H (`gather_rows`), and every line re-rank kernel C
(`gather_rerank`), so bin ids, extents and candidate ids equal the JAX
package's bit for bit given the same distance tables.  Duplicate
masking sorts the candidate ids with `torch.sort` (ROADMAP.md queue 2).
Queries run on the device of the tree and database tensors.  Bin-hash terms
are uint32 values held in int64.
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
from pqt_tpu_torch.ops.cuda.gather import gather_rows, lut_gather
from pqt_tpu_torch.ops.cuda.primitives import (bitonic_topk, block_scan,
                                               gather_sqdist)
from pqt_tpu_torch.ops.cuda.rerank import gather_rerank

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


def _part_candidates(cfg: PQTConfig, tree: PQTree, queries: torch.Tensor):
    """Per part, the k1_query best L1 cells x all c2 refinements: (d2 (B, p,
    L) level-2 distances, codes (B, p, L) int64 part codes l1*c2 + l2),
    L = k1_query * c2, in (L1 rank, l2) order."""
    W = cfg.k1_query
    d1 = level1_tables(cfg, tree, queries)               # (B, p, c1)
    d2 = level2_tables(cfg, tree, queries)               # (B, p, c1, c2)
    _, l1_idx = _topk(d1, W)                             # (B, p, W)
    B, p = d1.shape[:2]
    cand_d2 = torch.gather(d2, 2, l1_idx[..., None].expand(B, p, W, cfg.c2))
    L = W * cfg.c2
    codes = (l1_idx[..., None] * cfg.c2 +
             torch.arange(cfg.c2, device=queries.device)).reshape(B, p, L)
    return cand_d2.reshape(B, p, L), codes


def _pair_occupancy(cfg: PQTConfig, pair_occ: torch.Tensor,
                    cells: torch.Tensor) -> torch.Tensor:
    """Kernel E over the flattened (p/2, radix^2) pair table: cells (B,
    p/2, n) pair-cell ids ca * radix + cb -> their uint8 occupancy."""
    r2 = cfg.part_radix ** 2
    row = torch.arange(cells.shape[1], device=cells.device)[:, None] * r2
    return lut_gather(pair_occ.reshape(-1), (cells + row).to(torch.int32))


def _pair_stage(cfg: PQTConfig, tree: PQTree, queries: torch.Tensor,
                pair_occ: Optional[torch.Tensor] = None):
    """Per part-pair, the pair_top_m best (l1,l2) x (l1,l2) combinations.

    Returns (d_pairs (B, p/2, M) ascending sums, h_pairs (B, p/2, M) int64
    uint32 partial bin terms, exact).  With `pair_occ`, pairs absent from
    the database get +inf and sort behind every live pair.
    """
    flat_d2, codes = _part_candidates(cfg, tree, queries)
    B, p, L = flat_d2.shape
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
        occ = _pair_occupancy(cfg, pair_occ, ca * cfg.part_radix + cb)
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


def _local_bins(bins: torch.Tensor, local: int, bin_offset):
    """Bin ids of a hash-range shard whose first slot is global slot
    `bin_offset`: (local ids, 0 outside the shard; in_range mask, or None
    when there is no offset and every id is in range)."""
    if bin_offset is None:
        return bins, None
    b = bins - bin_offset
    in_range = (b >= 0) & (b < local)
    return torch.where(in_range, b, 0).to(torch.int32), in_range


def _probe_bins(cfg: PQTConfig, bins: torch.Tensor, prefix2: torch.Tensor,
                bin_offset=None):
    """One extent-row gather (kernel H) per enumerated bin, then the first
    max_bins non-empty bins in enumeration order: (start, count) (B, nb)
    int32.  With `bin_offset`, prefix2 is a shard's table and bins outside
    it count as empty."""
    safe, in_range = _local_bins(bins, prefix2.shape[0], bin_offset)
    ext = gather_rows(prefix2, safe.contiguous())        # (B, E, 2)
    start = ext[..., 0]
    cnt = ext[..., 1] - ext[..., 0]
    if in_range is not None:
        cnt = torch.where(in_range, cnt, 0)
    return binning.compact_nonempty_bins(start, cnt,
                                         min(cfg.max_bins, bins.shape[1]))


def _sorted_part_lists(cfg: PQTConfig, tree: PQTree, queries: torch.Tensor):
    """Per part, the candidate (l1, l2) codes sorted by level-2 distance,
    ties in candidate order (kernel A, like the JAX package's stable
    argsort): (sorted_d2 (B, p, L), sorted_codes (B, p, L) int64)."""
    flat_d2, codes = _part_candidates(cfg, tree, queries)
    sorted_d2, order = _topk(flat_d2, flat_d2.shape[-1])
    return sorted_d2, torch.gather(codes, 2, order)


@functools.lru_cache(maxsize=16)
def _parts_sequence_on(base: int, p: int, n_enum: int, device: torch.device):
    """The parts traversal on `device`, uploaded once: (ranks (p, E) int64,
    the per-part rank of every enumeration slot, and cells (p/2, E) int64,
    the (rank 2j, rank 2j+1) cell rank_a * base + rank_b of every slot)."""
    seq = distseq.static_sequence(base, p)[:n_enum].astype("int64")
    n2 = 2 * (p // 2)
    cells = seq[:, 0:n2:2] * base + seq[:, 1:n2:2]
    return (torch.tensor(seq.T.copy(), device=device),
            torch.tensor(cells.T.copy(), device=device))


def _enumerate_bins(cfg: PQTConfig, sorted_d2: torch.Tensor,
                    sorted_codes: torch.Tensor, counts: torch.Tensor,
                    bin_offset=None, pair_occ: Optional[torch.Tensor] = None):
    """Traversal-sequence bin enumeration and occupancy compaction.

    Enumeration slot e combines, per part j, the code of rank
    static_sequence(base, p)[e, j] (base = min(L, 16)), hashed to a bin id.
    With `pair_occ` (and the filter enabled) a slot survives only if each of
    its (part 2j, 2j+1) code pairs occurs in the database; the first
    pair_filter_slack * max_bins survivors (a kernel-B compaction) then get
    their occupancy looked up (kernel E).  Without it every slot's occupancy
    is looked up.  The first max_bins non-empty bins are kept (kernel-B
    compaction).  `counts` may be a hash-range shard's table whose first
    slot is global slot `bin_offset`; bins outside it count as empty.
    Returns (bins (B, max_bins) local slot ids, bin_counts (B, max_bins));
    slots past the last non-empty bin have count 0.
    """
    B, p, L = sorted_codes.shape
    base = min(L, 16)                  # reference clamps to 16 (ProTree.cu:135)
    n_enum = min(cfg.bin_enum_factor * cfg.max_bins, base ** p)
    ranks, cells = _parts_sequence_on(base, p, n_enum, sorted_codes.device)
    c16 = sorted_codes[:, :, :base]                          # (B, p, base)
    part_codes = torch.gather(c16, 2, ranks[None].expand(B, p, n_enum))
    bin_ids, in_range = _local_bins(
        binning.hashed_bin_ids(part_codes.transpose(1, 2), cfg.part_radix,
                               cfg.hash_size), counts.shape[0], bin_offset)
    bin_ids = bin_ids.contiguous()

    if pair_occ is not None and cfg.pair_filter_enabled:
        n_pairs = p // 2
        r = cfg.part_radix
        # occupancy of every (rank_a, rank_b) cell of every pair of parts
        pc = (c16[:, 0:2 * n_pairs:2, :, None] * r +
              c16[:, 1:2 * n_pairs:2, None, :]).reshape(B, n_pairs,
                                                         base * base)
        occ = _pair_occupancy(cfg, pair_occ, pc)           # (B, p/2, base^2)
        slot_occ = torch.gather(occ, 2, cells[None].expand(B, n_pairs,
                                                           n_enum))
        passes = torch.all(slot_occ > 0, dim=1)
        if in_range is not None:
            passes = passes & in_range
        passes = passes.to(torch.int32)
        # stage 1: compact by the pair filter; stage 2: true occupancy of
        # the survivors only, then the final compaction
        m1 = min(n_enum, int(cfg.pair_filter_slack * cfg.max_bins))
        bins1, pass1 = binning.compact_nonempty_bins(bin_ids, passes, m1)
        valid1 = pass1 > 0
        cnt1 = torch.where(
            valid1, lut_gather(counts, torch.where(valid1, bins1, 0)), 0)
        return binning.compact_nonempty_bins(bins1, cnt1, cfg.max_bins)

    bin_counts = lut_gather(counts, bin_ids)                 # (B, E)
    if in_range is not None:
        bin_counts = torch.where(in_range, bin_counts, 0)
    return binning.compact_nonempty_bins(bin_ids, bin_counts, cfg.max_bins)


def _probe_parts(cfg: PQTConfig, tree: PQTree, counts, queries,
                 pair_occ=None, bin_offset=None):
    """The parts pipeline's probed bins: (bins, bin_counts) (B, max_bins)."""
    sorted_d2, sorted_codes = _sorted_part_lists(cfg, tree, queries)
    return _enumerate_bins(cfg, sorted_d2, sorted_codes, counts,
                           bin_offset=bin_offset, pair_occ=pair_occ)


def _slabs(cfg: PQTConfig, start, cnt):
    """(slab_starts, slab_valid) (B, T) of the slab windows over the probed
    bins' extents, T = ceil(max_candidates / slab_size)."""
    S = cfg.slab_size
    return binning.gather_slabs(start, cnt, -(-cfg.max_candidates // S), S,
                                cfg.max_vec_per_bin)


def _candidate_positions(cfg: PQTConfig, n_rows: int, start, cnt):
    """The candidates' CSR positions from the probed bins' extents, in a
    payload of n_rows rows: (positions (B, K) int32, valid (B, K)).

    "rows" mode: capped per-row positions, 0 where invalid, K =
    max_candidates.  "slabs" mode: every row of windows of slab_size
    consecutive rows per bin (`binning.slab_positions`), K the
    slab-rounded size; an invalid slot's position lies past the payload's
    end only when the payload is shorter than a slab.
    """
    if cfg.gather_mode == "slabs":
        return binning.slab_positions(n_rows, *_slabs(cfg, start, cnt),
                                      cfg.slab_size)
    positions, valid = binning.gather_candidates(
        start, cnt, cfg.max_candidates, cfg.max_vec_per_bin)
    return torch.where(valid, positions, 0), valid


def _collect_rows(cfg: PQTConfig, payload: torch.Tensor, start, cnt):
    """The candidates' payload rows, for the exact re-rank's ids: one
    payload-row gather (kernel H) at the capped per-row positions, or of
    slab_size rows per slab window (H with a span).  Returns (rows (B, K,
    W), valid (B, K), positions (B, K) int32), as `_candidate_positions`."""
    if cfg.gather_mode == "slabs":
        slabs = _slabs(cfg, start, cnt)
        rows, valid = binning.fetch_slab_rows(payload, *slabs,
                                              cfg.slab_size)
        positions, _ = binning.slab_positions(payload.shape[0], *slabs,
                                              cfg.slab_size)
        return rows, valid, positions
    positions, valid = _candidate_positions(cfg, payload.shape[0], start, cnt)
    return gather_rows(payload, positions), valid, positions


def _top_ids(dists: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Kernel A's k smallest of each row and the candidate ids they belong
    to, -1 where the distance is +inf: (ids (B, k'), dists (B, k')), k' =
    min(k, K)."""
    top_d, top_i = _topk(dists, min(k, dists.shape[-1]))
    ids = torch.gather(cand_ids, 1, top_i)
    return torch.where(torch.isfinite(top_d), ids, -1), top_d


def _line_candidates(cfg: PQTConfig, tree: PQTree, payload, queries,
                     positions: torch.Tensor, valid: torch.Tensor):
    """Kernel C over the candidates at `positions` (B, K) int32: each
    payload row read once, (cand_ids (B, K) the rows' ids, line distances
    (B, K), +inf where invalid)."""
    q_line = line_tables(cfg, tree, queries).contiguous()   # (B, lp, c1)
    return gather_rerank(payload, positions.contiguous(), valid.contiguous(),
                         q_line, cfg.payload_is_compact)


def _line_rerank(cfg: PQTConfig, tree: PQTree, payload, queries, start, cnt,
                 k: int, want_candidates: bool):
    """Candidate positions, ids and line distances (kernel C) and top-k
    (kernel A): the shared tail of both pipelines' cores."""
    positions, valid = _candidate_positions(cfg, payload.shape[0], start,
                                            cnt)
    cand_ids, dists = _line_candidates(cfg, tree, payload, queries,
                                       positions, valid)
    if cfg.dedup_candidates:
        dists = _mask_duplicate_candidates(cand_ids, valid, dists)
    n_cand = torch.sum(valid, dim=-1)
    if want_candidates:
        return cand_ids, dists, n_cand, positions
    return _top_ids(dists, cand_ids, k) + (n_cand,)


def query_core_pair(cfg: PQTConfig, tree: PQTree, prefix2, payload,
                    queries, k: int, bin_offset=None, pair_occ=None,
                    want_candidates: bool = False):
    """Pair-pipeline query over the raw CSR tensors.

    Returns (ids (B, k) int32, line distances (B, k), n_candidates (B,));
    -1 ids mark missing results.  With want_candidates=True, returns the
    whole candidate set before top-k instead: (cand_ids (B, K), dists
    (B, K) +inf where invalid, n_candidates, positions (B, K)).
    `bin_offset`: prefix2 is the table of a hash-range shard starting at
    that global slot.
    """
    queries = queries.to(torch.float32)
    _, h_pairs, exact = _pair_stage(cfg, tree, queries, pair_occ)
    bins = _enumerate_bins_pair(cfg, h_pairs, exact)
    start, cnt = _probe_bins(cfg, bins, prefix2, bin_offset)
    return _line_rerank(cfg, tree, payload, queries, start, cnt, k,
                        want_candidates)


def query_core(cfg: PQTConfig, tree: PQTree, prefix, counts, payload,
               queries, k: int, bin_offset=None, pair_occ=None,
               want_candidates: bool = False):
    """Parts-pipeline query over the raw CSR tensors (prefix and counts the
    (hash_size,) occupancy tables, or a shard's from global slot
    `bin_offset`); same results as query_core_pair."""
    queries = queries.to(torch.float32)
    bins, bin_counts = _probe_parts(cfg, tree, counts, queries, pair_occ,
                                    bin_offset)
    return _line_rerank(cfg, tree, payload, queries,
                        lut_gather(prefix, bins.contiguous()), bin_counts, k,
                        want_candidates)


def _row_sqdist(queries: torch.Tensor, table: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Exact squared distances (B, K) of the raw rows table[positions] to
    their queries (B, dim), by one kernel that reads each row once
    (`gather_sqdist`).  positions (B, K) int32 must lie inside the table:
    callers map an invalid slot to row 0 and mask its distance."""
    return gather_sqdist(table, positions, queries.contiguous())


def query_core_exact(cfg: PQTConfig, tree: PQTree, prefix2, payload,
                     vectors_csr, queries, k: int, bin_offset=None,
                     pair_occ=None):
    """Exact re-rank over the raw CSR tensors, reading `vectors_csr`, the
    raw vectors in CSR order (an out-of-core build's layout), by CSR
    position: every gathered candidate ranked by its true squared distance
    (payload rows by kernel H, in the gather mode's rows or slab windows;
    the raw rows at the candidates' positions read and their distances
    summed by `gather_sqdist`; top-k by kernel A).  Either pipeline;
    `bin_offset` as in query_core_pair.  Returns (ids (B, k'), dists (B,
    k'), n_candidates), k' = min(k, K)."""
    queries = queries.to(torch.float32)
    if cfg.pair_pipeline_enabled:
        _, h_pairs, exact = _pair_stage(cfg, tree, queries, pair_occ)
        bins = _enumerate_bins_pair(cfg, h_pairs, exact)
        start, cnt = _probe_bins(cfg, bins, prefix2, bin_offset)
    else:
        counts = prefix2[:, 1] - prefix2[:, 0]
        bins, cnt = _probe_parts(cfg, tree, counts, queries, pair_occ,
                                 bin_offset)
        start = gather_rows(prefix2, bins.contiguous())[..., 0]
    rows, valid, positions = _collect_rows(cfg, payload, start, cnt)
    cand_ids = rows[..., 0]
    dists = torch.where(valid, _row_sqdist(
        queries, vectors_csr, torch.where(valid, positions, 0)), _INF)
    if cfg.dedup_candidates:
        dists = _mask_duplicate_candidates(cand_ids, valid, dists)
    return _top_ids(dists, cand_ids, k) + (torch.sum(valid, dim=-1),)


def _parts_candidates(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                      queries: torch.Tensor):
    """The parts pipeline's candidate ids by capped per-row positions,
    whatever the gather mode (as in the JAX package): (cand_ids (B, K)
    int32, the payload's first row where invalid; valid (B, K))."""
    bins, bin_counts = _probe_parts(cfg, tree, db.counts, queries,
                                    db.pair_occ)
    positions, valid = binning.gather_candidates(
        lut_gather(db.prefix, bins.contiguous()), bin_counts,
        cfg.max_candidates,
        cfg.max_vec_per_bin)
    safe_pos = torch.where(valid, positions, 0)
    return gather_rows(db.payload, safe_pos)[..., 0], valid


def _pad_k(ids, dists, k):
    pad = k - ids.shape[1]
    if pad > 0:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        dists = torch.nn.functional.pad(dists, (0, pad), value=_INF)
    return ids, dists


def _exact_top(queries, table, positions, cand_ids, valid, k):
    """The top-k (kernel A) of the candidates by exact squared distance
    from their raw rows table[positions] (0 where invalid): (ids, dists)."""
    return _top_ids(torch.where(valid, _row_sqdist(queries, table, positions),
                                _INF), cand_ids, k)


def _require_vectors(db: PQTDatabase, what: str) -> None:
    if db.vectors is None and db.vectors_csr is None:
        raise ValueError(f"{what} needs raw vectors: build with "
                         "keep_vectors=True (in RAM or spilled)")


def query_knn(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
              queries: torch.Tensor, k: int,
              exact_rerank: bool = False) -> QueryResult:
    """Batched approximate k-NN: queries (B, dim) -> ids sorted by the line
    (or, with exact_rerank, exact) distance.  The pipeline is the pair
    pipeline when cfg.pair_pipeline_enabled, the parts pipeline otherwise.
    The exact re-rank reads db.vectors by id, or, for an out-of-core
    database that holds only vectors_csr, those by CSR position
    (query_core_exact)."""
    queries = queries.to(torch.float32)
    if exact_rerank and db.vectors is None:
        _require_vectors(db, "exact re-rank")
        ids, dists, n_cand = query_core_exact(
            cfg, tree, db.prefix2, db.payload, db.vectors_csr, queries, k,
            pair_occ=db.pair_occ)
    elif exact_rerank:
        if cfg.pair_pipeline_enabled:
            cand_ids, line_d, _, _ = query_core_pair(
                cfg, tree, db.prefix2, db.payload, queries, k,
                pair_occ=db.pair_occ, want_candidates=True)
            valid = torch.isfinite(line_d)      # duplicates already masked
            n_cand = torch.sum(valid, dim=-1)
        else:
            cand_ids, valid = _parts_candidates(cfg, tree, db, queries)
            n_cand = torch.sum(valid, dim=-1)
            if cfg.dedup_candidates:
                valid = valid & ~_duplicate_stats(cand_ids, valid)[0]
        ids, dists = _exact_top(queries, db.vectors,
                                torch.where(valid, cand_ids, 0), cand_ids,
                                valid, min(k, cfg.max_candidates))
    elif cfg.pair_pipeline_enabled:
        ids, dists, n_cand = query_core_pair(
            cfg, tree, db.prefix2, db.payload, queries, k,
            pair_occ=db.pair_occ)
    else:
        ids, dists, n_cand = query_core(
            cfg, tree, db.prefix, db.counts, db.payload, queries, k,
            pair_occ=db.pair_occ)
    ids, dists = _pad_k(ids, dists, k)
    return QueryResult(indices=ids, dists=dists, n_candidates=n_cand)


def query_candidates(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                     queries: torch.Tensor):
    """The gathered candidate set before any re-rank: (cand_ids (B, K)
    int32, valid (B, K) bool), for candidate recall.  As in the JAX
    package, the parts pipeline marks invalid slots with id -1 and the
    pair pipeline leaves whatever row they read."""
    queries = queries.to(torch.float32)
    if not cfg.pair_pipeline_enabled:
        cand_ids, valid = _parts_candidates(cfg, tree, db, queries)
        return torch.where(valid, cand_ids, -1), valid
    cand_ids, line_d, _, _ = query_core_pair(
        cfg, tree, db.prefix2, db.payload, queries, 0,
        pair_occ=db.pair_occ, want_candidates=True)
    return cand_ids, torch.isfinite(line_d)


def query_knn_refine(cfg: PQTConfig, tree: PQTree, db: PQTDatabase,
                     queries: torch.Tensor, k: int, refine_factor: int = 8,
                     k_line: Optional[int] = None) -> QueryResult:
    """Two stages: line re-rank to k * refine_factor (or k_line) candidates,
    then exact re-rank of those from the raw vectors: db.vectors by id, or,
    for a database that holds only vectors_csr, those at the CSR positions
    the line top-k carried through (`gather_sqdist`)."""
    _require_vectors(db, "query_knn_refine")
    queries = queries.to(torch.float32)
    k1 = k_line or k * refine_factor
    if db.vectors is not None:
        stage1 = query_knn(cfg, tree, db, queries, k1)
        ids1, n_cand = stage1.indices, stage1.n_candidates
        table, rows_at = db.vectors, torch.where(ids1 >= 0, ids1, 0)
    else:
        if cfg.pair_pipeline_enabled:
            cand_ids, line_d, n_cand, pos = query_core_pair(
                cfg, tree, db.prefix2, db.payload, queries, 0,
                pair_occ=db.pair_occ, want_candidates=True)
        else:
            cand_ids, line_d, n_cand, pos = query_core(
                cfg, tree, db.prefix, db.counts, db.payload, queries, 0,
                pair_occ=db.pair_occ, want_candidates=True)
        top_d, idx1 = _topk(line_d, min(k1, line_d.shape[-1]))
        live = torch.isfinite(top_d)
        ids1 = torch.where(live, torch.gather(cand_ids, 1, idx1), -1)
        table = db.vectors_csr
        rows_at = torch.where(live, torch.gather(pos, 1, idx1), 0)
    ids, dists = _exact_top(queries, table, rows_at, ids1, ids1 >= 0, k)
    ids, dists = _pad_k(ids, dists, k)
    return QueryResult(indices=ids, dists=dists, n_candidates=n_cand)
