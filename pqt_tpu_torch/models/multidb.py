"""The multi-database (group_parts) engine: one inverted file per part group.

Port of pqt_tpu/models/multidb.py.  The p parts are split into g =
p / group_parts groups; each group gets its own inverted file over
(c1*c2)^group_parts bins, a query probes every group's file on its own
(max_bins / g bins and max_candidates / g candidates a group), and the
candidate union, deduplicated, is ranked: by occurrences (how many groups
found the vector, then line distance; `cfg.multidb_rank="occurrence"`), by
line distance alone, or by exact distance (`exact_rerank`).  With
group_parts == 2 each group is a pair of parts, and the pair-occupancy
filter drops enumerated bins whose code pair no vector carries.

Per query batch, on the kernels of the single-database paths:

  * the sorted part lists (kernel A) and, per group, the enumerated bins'
    part codes as a `torch.gather` of the traversal ranks, their
    occupancy and pair-filter lookups (kernel E), the compaction of the
    non-empty bins and the candidate positions (kernel B), and the line
    re-rank of that group's payload rows by position (kernel C,
    `gather_rerank`), all groups sharing one set of line tables;
  * the dedup (`_duplicate_stats`, a `torch.sort` of the candidate ids);
  * the ranking: the occurrence order is two kernel-A passes, a full
    (value, index) sort of the line distances and a stable pass over the
    small integer key (finite first, then most occurrences), which is the
    JAX package's stable three-key sort to the bit, ties included; the
    distance order and the exact re-rank's top-k are one kernel-A top-k,
    the exact distances read the raw vectors by id (`gather_sqdist`).

A spilled build keeps each group's payload in a host memmap
(`<spill_path>.g<i>`, the JAX package's bytes); `place_multi_database`
uploads every host leaf to the card once, and `query_multi_knn` refuses a
host leaf rather than copy it on every call.  `query_multi_knn` is
`graphed` with the JAX package's static arguments (utils/graphs.py): the
refusal runs in a key's eager first call, as JAX's checks run at trace
time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import (PQTDatabase, _assemble_device,
                                     _check_tree_device, _device_vectors,
                                     _encode_rows, _host_rows, to_device)
from pqt_tpu_torch.models.query import (QueryResult, _duplicate_stats,
                                        _pad_k, _parts_sequence_on,
                                        _row_sqdist, _sorted_part_lists,
                                        _top_ids, _topk)
from pqt_tpu_torch.models.tree import PQTree, line_tables
from pqt_tpu_torch.ops import binning
from pqt_tpu_torch.ops.cuda.gather import lut_gather
from pqt_tpu_torch.ops.cuda.rerank import gather_rerank
from pqt_tpu_torch.utils import tracing
from pqt_tpu_torch.utils.device import resolve_device
from pqt_tpu_torch.utils.graphs import graphed

_INF = float("inf")
# payload rows copied from the card to a spill file per step
_SPILL_ROWS = 1 << 20


class MultiDatabase(NamedTuple):
    """g inverted files sharing one tree.  The raw vectors (for the exact
    re-rank) are stored once, by original id; pair_occ is each group's
    code-pair occupancy when group_parts == 2."""
    databases: tuple                        # tuple[PQTDatabase], per group
    vectors: Optional[torch.Tensor] = None  # (n, dim) uint8 or float32
    pair_occ: Optional[torch.Tensor] = None  # (g, radix^2) uint8

    @property
    def n_groups(self) -> int:
        return len(self.databases)

    @classmethod
    def from_numpy(cls, databases, vectors=None, pair_occ=None,
                   device="cuda") -> "MultiDatabase":
        """A multi-database from host arrays, for example the JAX
        package's: `databases` holds one (prefix, counts, payload) per
        group."""
        dev = resolve_device(device)
        return cls(
            databases=tuple(PQTDatabase.from_numpy(*d, device=dev)
                            for d in databases),
            vectors=None if vectors is None else to_device(vectors, dev),
            pair_occ=None if pair_occ is None else to_device(pair_occ, dev))


def place_multi_database(mdb: MultiDatabase, device="cuda") -> MultiDatabase:
    """Every leaf on `device`: host arrays and memmaps (a spilled payload)
    uploaded once, in row blocks; tensors moved."""
    dev = resolve_device(device)

    def put(leaf):
        if leaf is None:
            return None
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dev)
        return to_device(leaf, dev)

    return MultiDatabase(
        databases=tuple(PQTDatabase(*(put(x) for x in db))
                        for db in mdb.databases),
        vectors=put(mdb.vectors), pair_occ=put(mdb.pair_occ))


def assemble_multi_database(cfg: PQTConfig, part_codes, packed,
                            group_parts: int, spill_path=None,
                            device="cuda") -> tuple:
    """The groups' inverted files from encoded vectors: part_codes (n, p)
    and payload rows (n, W) int32 in id order (tensors or host arrays).
    Per group: the code-pair occupancy (group_parts == 2), the bin ids of
    its parts, and the CSR (histogram, prefix by kernel B, a stable sort
    by bin).  With `spill_path` each group's payload is written to the
    memmap `<spill_path>.g<i>` and stays on the host.

    Returns (databases tuple, pair_occ (g, radix^2) uint8 or None)."""
    dev = resolve_device(device)

    def put(a):
        return (a.to(dev) if isinstance(a, torch.Tensor) else
                torch.as_tensor(np.array(a), device=dev))

    part_codes, packed = put(part_codes).to(torch.int64), put(packed)
    g = cfg.p // group_parts
    radix = cfg.part_radix
    pair_occ = (torch.zeros((g, radix * radix), dtype=torch.uint8,
                            device=dev) if group_parts == 2 else None)
    dbs = []
    for gi in range(g):
        sub = part_codes[:, gi * group_parts:(gi + 1) * group_parts]
        if pair_occ is not None:
            pair_occ[gi, sub[:, 0] * radix + sub[:, 1]] = 1
        bins = binning.hashed_bin_ids(sub, radix, cfg.hash_size)
        prefix, counts, prefix2, payload = _assemble_device(cfg, bins,
                                                            packed)
        if spill_path:
            mm = np.memmap(f"{spill_path}.g{gi}", np.int32, mode="w+",
                           shape=tuple(payload.shape))
            for s in range(0, payload.shape[0], _SPILL_ROWS):
                mm[s:s + _SPILL_ROWS] = payload[s:s + _SPILL_ROWS].cpu().numpy()
            mm.flush()
            payload = mm
        dbs.append(PQTDatabase(prefix=prefix, counts=counts, payload=payload,
                               pair_occ=None, vectors=None, prefix2=prefix2))
    return tuple(dbs), pair_occ


def build_multi_database(cfg: PQTConfig, tree: PQTree, data,
                         group_parts: int, encode_chunk: int = 65536,
                         keep_vectors: bool = False, spill_path=None,
                         device="cuda") -> MultiDatabase:
    """Build one inverted file per part group on `device` (the tree's).

    Vectors keep their dtype (uint8 stays uint8 on the card; any other
    than uint8 or float32 becomes float32); the rows go up a chunk at a
    time as in `build_database` (models/db.py `_encode_rows`), and the
    encode casts each.  With `spill_path` the groups' payloads go to host
    memmaps (`<spill_path>.g<i>`); place the result on the card with
    `place_multi_database` before querying.
    """
    dev = _check_tree_device(tree, device)
    if cfg.p % group_parts:
        raise ValueError(f"group_parts {group_parts} does not divide p "
                         f"{cfg.p}")
    data = _host_rows(data)
    tracing.mark("build.upload", dev)
    vectors = _device_vectors(data, dev) if keep_vectors else None
    codes_l, packed_l = [], []
    for _, (_, pc, rows) in _encode_rows(cfg, tree, data, encode_chunk,
                                         vectors=vectors):
        codes_l.append(pc)
        packed_l.append(rows)
    tracing.mark("build.assemble", dev)
    dbs, pair_occ = assemble_multi_database(
        cfg, torch.cat(codes_l), torch.cat(packed_l), group_parts,
        spill_path, dev)
    tracing.mark("build.end", dev)
    return MultiDatabase(databases=dbs, vectors=vectors, pair_occ=pair_occ)


def _group_bins(cfg: PQTConfig, sorted_codes: torch.Tensor,
                counts: torch.Tensor, group_parts: int, group_idx: int,
                max_bins: int, pair_occ_g: Optional[torch.Tensor] = None):
    """Enumerate and compact one group's probed bins: (bins, bin_counts)
    (B, max_bins).

    Slot e of the traversal takes, per part j of the group, the code of
    rank static_sequence(base, group_parts)[e, j] (base = min(L, 16)), a
    gather of the sorted codes by the traversal ranks.  Occupancy is one
    lookup a slot (kernel E); with `pair_occ_g` ((radix^2,) uint8,
    group_parts == 2) a slot whose code pair no vector carries counts as
    empty (a second lookup).  The first max_bins non-empty slots are kept
    (kernel B).
    """
    B, _, L = sorted_codes.shape
    lo = group_idx * group_parts
    base = min(L, 16)
    n_enum = min(cfg.bin_enum_factor * max_bins, base ** group_parts)
    ranks, _ = _parts_sequence_on(base, group_parts, n_enum,
                                  sorted_codes.device)
    codes = sorted_codes[:, lo:lo + group_parts, :base]
    part_codes = torch.gather(codes, 2, ranks[None].expand(B, group_parts,
                                                           n_enum))
    part_codes = part_codes.transpose(1, 2)                 # (B, E, gp)
    bin_ids = binning.hashed_bin_ids(part_codes, cfg.part_radix,
                                     cfg.hash_size).contiguous()
    bin_counts = lut_gather(counts, bin_ids)
    if pair_occ_g is not None and group_parts == 2:
        cell = (part_codes[..., 0] * cfg.part_radix + part_codes[..., 1])
        occ = lut_gather(pair_occ_g, cell.to(torch.int32).contiguous())
        bin_counts = torch.where(occ > 0, bin_counts, 0)
    return binning.compact_nonempty_bins(bin_ids, bin_counts, max_bins)


def _occurrence_top(dists: torch.Tensor, occ: torch.Tensor,
                    cand_ids: torch.Tensor, k: int):
    """The k first candidates in (finite first, occurrences descending,
    line distance ascending, slot ascending) order: (ids, -1 where the
    distance is +inf; dists) (B, k).

    Kernel A twice: a full (value, index) sort of the distances, then a
    pass over the integer key (-occurrences, or 1 for +inf) of the
    distance-sorted slots, which keeps their order among equal keys."""
    K = dists.shape[1]
    sorted_d, perm = _topk(dists.contiguous(), K)
    key = torch.where(torch.isfinite(sorted_d),
                      -torch.gather(occ, 1, perm).to(torch.float32), 1.0)
    _, sel = _topk(key.contiguous(), k)
    slot = torch.gather(perm, 1, sel)
    out_d = torch.gather(sorted_d, 1, sel)
    ids = torch.gather(cand_ids, 1, slot)
    return torch.where(torch.isfinite(out_d), ids, -1), out_d


def _require_placed(mdb: MultiDatabase, dev: torch.device,
                    exact: bool) -> None:
    leaves = [("pair_occ", mdb.pair_occ)] + [
        (f"group {i} {name}", getattr(db, name))
        for i, db in enumerate(mdb.databases)
        for name in ("prefix", "counts", "payload")]
    if exact:
        if mdb.vectors is None:
            raise ValueError("exact_rerank needs "
                             "build_multi_database(keep_vectors=True)")
        leaves.append(("vectors", mdb.vectors))
    for name, leaf in leaves:
        if leaf is not None and (not isinstance(leaf, torch.Tensor)
                                 or leaf.device != dev):
            raise ValueError(
                f"query_multi_knn: the {name} is not a tensor on {dev}; "
                "upload the database once with place_multi_database")


@graphed(static_argnums=(0, 4, 5))
def query_multi_knn(cfg: PQTConfig, tree: PQTree, mdb: MultiDatabase,
                    queries: torch.Tensor, k: int,
                    exact_rerank: bool = False) -> QueryResult:
    """Probe every group's inverted file and rank the deduplicated union.

    Per group: max_bins / g probed bins and max_candidates / g candidates,
    re-ranked by line distance (kernel C).  Repeats of an id across groups
    are masked to +inf, the first slot keeping it with its occurrence
    count.  Ranking: exact distances from the raw vectors by id with
    `exact_rerank`, else cfg.multidb_rank ("occurrence" or "distance").
    Returns ids (-1 where none) and distances (B, k), and the candidates
    gathered per query.
    """
    g = mdb.n_groups
    gp = cfg.p // g
    _require_placed(mdb, tree.cb1.device, exact_rerank)
    queries = queries.to(torch.float32)
    _, sorted_codes = _sorted_part_lists(cfg, tree, queries)
    per_bins = max(cfg.max_bins // g, 1)
    per_cand = max(cfg.max_candidates // g, 1)
    q_line = line_tables(cfg, tree, queries).contiguous()
    use_filter = (mdb.pair_occ is not None and cfg.pair_filter_enabled
                  and gp == 2)
    ids_l, dists_l, valid_l = [], [], []
    for gi, db in enumerate(mdb.databases):
        bins, bin_counts = _group_bins(
            cfg, sorted_codes, db.counts, gp, gi, per_bins,
            mdb.pair_occ[gi] if use_filter else None)
        positions, valid = binning.gather_candidates(
            lut_gather(db.prefix, bins.contiguous()), bin_counts, per_cand,
            cfg.max_vec_per_bin)
        ids, dists = gather_rerank(
            db.payload, torch.where(valid, positions, 0).contiguous(),
            valid.contiguous(), q_line, cfg.payload_is_compact)
        ids_l.append(ids)
        dists_l.append(dists)
        valid_l.append(valid)
    cand_ids = torch.cat(ids_l, dim=1)
    valid = torch.cat(valid_l, dim=1)
    dup, occ = _duplicate_stats(cand_ids, valid)
    dists = torch.where(dup, _INF, torch.cat(dists_l, dim=1))
    k_eff = min(k, cand_ids.shape[1])
    if exact_rerank:
        live = torch.isfinite(dists)
        exact = _row_sqdist(queries, mdb.vectors,
                            torch.where(live, cand_ids, 0).contiguous())
        ids, out_d = _top_ids(torch.where(live, exact, _INF), cand_ids,
                              k_eff)
    elif cfg.multidb_rank == "occurrence":
        ids, out_d = _occurrence_top(dists, occ, cand_ids, k_eff)
    else:
        ids, out_d = _top_ids(dists.contiguous(), cand_ids, k_eff)
    ids, out_d = _pad_k(ids, out_d, k)
    return QueryResult(indices=ids, dists=out_d,
                       n_candidates=torch.sum(valid, dim=-1))
