"""Multi-device serving: a hash-range-sharded database and a merged top-k.

Port of pqt_tpu/parallel/sharded.py.  The database is split by hash range:

  * each of S shards owns a contiguous range of span = hash_size / S bins,
    and, since the CSR payload is sorted by bin, a contiguous slice of the
    payload (and of the raw vectors in CSR order); its prefix is rebased to
    that slice;
  * every shard runs a whole query core (`query_core_pair`, `query_core`,
    `query_core_exact` or `query_big_core`) over its own tables with
    bin_offset = s * span, so bins outside its range count as empty, and
    produces its own top-k;
  * the per-shard lists are merged by kernel A (`_top_ids`: the k smallest
    of each query's shard-major row of S * k' distances, lowest index first
    on ties, which is `lax.top_k`'s order), so given the same per-shard
    lists the merged ids equal the JAX package's to the bit;
  * the batch can also be cut into `batch_split` slices, each served by its
    own (shard, slice) cell of the device grid (the JAX mesh's second axis).

The mesh is a list of torch devices, shard-major: cell (s, j) -- shard s,
batch slice j -- is `devices[s * batch_split + j]`; a device may repeat
(several shards on one card, or on the CPU).  In one process every cell's
core is launched on its device before anything waits (the cores make no
host sync), then the (B, k') lists move to the first cell's device with
non_blocking copies and are merged there.  Across processes (`group`, a
torch.distributed process group) each rank serves its own shards, shard s
on rank s // (S / world); the lists are all-gathered over the group in
rank (= shard) order, every rank runs the same merge, and n_candidates is
an all-reduce sum.  The tree and the queries are taken where they are: a
tensor (tree) on the cell's device, or a mapping from device to replica
(`parallel.distributed.replicate`); nothing is moved to a device behind the
caller's back.

The data-parallel building blocks split rows over devices: the encode
(`make_dp_encode_fn`, each chunk a replay of the graphed `chunk_codes` on
its device) and one Lloyd step (`make_dp_kmeans_step`, served as the
sharded step is: one graph a distinct device, then the merge with the
all-reduces).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from collections.abc import Mapping
from typing import NamedTuple, Optional

import numpy as np
import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import PQTDatabase, chunk_codes, to_device
from pqt_tpu_torch.models.query import (QueryResult, _top_ids, query_core,
                                        query_core_exact, query_core_pair)
from pqt_tpu_torch.models.query_big import query_big_core
from pqt_tpu_torch.utils import graphs
from pqt_tpu_torch.utils.device import resolve_device

MODES = ("line", "exact", "big")
# the leaves with a leading shard axis
_SHARD_LEAVES = ("prefix", "counts", "prefix2", "payload", "vectors")


class ShardedDatabase(NamedTuple):
    """A database split into S hash-range shards.

    On the host (`shard_database`, `build_local_shards`) each leaf is a
    numpy array with a leading shard axis.  Placed (`place_sharded_db`),
    each of those leaves is a tuple of tensors, one per cell of the device
    grid, shard-major; cells of one shard on one device share a tensor.
    """
    prefix: object          # (S, span) int32, rebased to each shard's slice
    counts: object          # (S, span) int32
    prefix2: object         # (S, span, 2) int32 rebased (start, end) extents
    payload: object         # (S, max_n, w) int32, -1 in the id column of
                            # the padding rows
    n_per_shard: np.ndarray  # (S,) int32 true payload lengths (host)
    pair_occ: object        # (p//2, radix^2) uint8, the global table (host),
                            # or placed: one copy per device, by cell
    vectors: object = None  # (S, max_n, dim) raw vectors in CSR order, in
                            # their own dtype (uint8 for SIFT)

    @property
    def n_shards(self) -> int:
        return len(self.n_per_shard)


def _stack_shards(span: int, prefix: np.ndarray, counts: np.ndarray,
                  payload: np.ndarray, vectors_csr: Optional[np.ndarray],
                  pad_to_multiple: int) -> ShardedDatabase:
    """Split CSR host arrays covering len(prefix) // span shards' bins into
    stacked shards (the body of the JAX package's shard_database and
    build_local_shards).  Shard i's payload is [prefix[i*span],
    prefix[(i+1)*span]); its prefix is rebased to that slice.  Reads the
    payload and vectors (numpy arrays or memmaps) slice by slice."""
    k = prefix.shape[0] // span
    n = payload.shape[0]
    starts = [int(prefix[i * span]) for i in range(k)]
    ends = starts[1:] + [n]
    lens = [e - s for s, e in zip(starts, ends)]
    max_n = max(max(lens), 1)
    max_n = -(-max_n // pad_to_multiple) * pad_to_multiple

    sh_prefix = np.empty((k, span), np.int32)
    sh_counts = np.empty((k, span), np.int32)
    sh_prefix2 = np.empty((k, span, 2), np.int32)
    sh_payload = np.zeros((k, max_n, payload.shape[1]), np.int32)
    sh_payload[:, :, 0] = -1          # id column: -1 marks padding
    sh_vectors = None
    if vectors_csr is not None:
        sh_vectors = np.zeros((k, max_n, vectors_csr.shape[1]),
                              vectors_csr.dtype)
    for i in range(k):
        sh_prefix[i] = prefix[i * span:(i + 1) * span] - starts[i]
        sh_counts[i] = counts[i * span:(i + 1) * span]
        sh_prefix2[i, :, 0] = sh_prefix[i]
        sh_prefix2[i, :, 1] = sh_prefix[i] + sh_counts[i]
        sh_payload[i, :lens[i]] = payload[starts[i]:ends[i]]
        if sh_vectors is not None:
            sh_vectors[i, :lens[i]] = vectors_csr[starts[i]:ends[i]]
    return ShardedDatabase(
        prefix=sh_prefix, counts=sh_counts, prefix2=sh_prefix2,
        payload=sh_payload, n_per_shard=np.asarray(lens, np.int32),
        pair_occ=None, vectors=sh_vectors)


def _host(x):
    """A host leaf as a numpy array (memmaps pass through); a tensor on a
    card is refused: sharding reads host arrays."""
    if x is None or isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor) and x.device.type != "cpu":
        raise TypeError("shard_database takes a database with host leaves "
                        f"(numpy arrays or memmaps), not tensors on "
                        f"{x.device}; load it with "
                        "io.artifacts.load_database_host")
    return np.asarray(x)


def shard_database(cfg: PQTConfig, db: PQTDatabase, n_shards: int,
                   pad_to_multiple: int = 1024) -> ShardedDatabase:
    """Split a built database into hash-range shards, on the host.

    `db` holds host leaves (numpy arrays or memmaps, as
    `load_database_host` or a merge with to_device=False gives them).  The
    raw vectors go into the shards in CSR order: `vectors_csr` as it is,
    or `vectors` (by id) re-laid as vectors[ids].  hash_size must divide
    evenly by n_shards (ValueError).
    """
    if n_shards < 1 or cfg.hash_size % n_shards:
        raise ValueError(f"hash_size {cfg.hash_size} does not divide into "
                         f"{n_shards} shards")
    payload = _host(db.payload)
    vectors_csr = _host(db.vectors_csr)
    if vectors_csr is None and db.vectors is not None:
        vectors_csr = _host(db.vectors)[np.asarray(payload[:, 0])]
    sdb = _stack_shards(cfg.hash_size // n_shards, _host(db.prefix),
                        _host(db.counts), payload, vectors_csr,
                        pad_to_multiple)
    return sdb._replace(pair_occ=_host(db.pair_occ))


def _devices(devices) -> list:
    return [resolve_device(d) for d in devices]


def place_sharded_db(sdb: ShardedDatabase, devices) -> ShardedDatabase:
    """Put each shard on its devices: `devices` is the shard-major grid of
    S * J cells (J = len(devices) / S batch slices; J = 1 for one device a
    shard).  Shards are uploaded one after another, each to the distinct
    devices of its cells only; pair_occ goes once to every distinct
    device."""
    devices = _devices(devices)
    S = sdb.n_shards
    if not devices or len(devices) % S:
        raise ValueError(f"{len(devices)} devices do not form a grid over "
                         f"{S} shards")
    J = len(devices) // S
    cells = {name: [] for name in _SHARD_LEAVES}
    for s in range(S):
        row = devices[s * J:(s + 1) * J]
        for name in _SHARD_LEAVES:
            host = getattr(sdb, name)
            if host is None:
                continue
            copies = {}
            for d in row:
                if d not in copies:
                    copies[d] = to_device(np.asarray(host[s]), d)
                cells[name].append(copies[d])
    occ = None
    if sdb.pair_occ is not None:
        on = {d: to_device(np.asarray(sdb.pair_occ), d)
              for d in dict.fromkeys(devices)}
        occ = tuple(on[d] for d in devices)
    return ShardedDatabase(
        n_per_shard=np.asarray(sdb.n_per_shard), pair_occ=occ,
        **{name: tuple(c) if getattr(sdb, name) is not None else None
           for name, c in cells.items()})


def _replica(x, dev: torch.device, what: str):
    """x on `dev`: the mapping's entry, or x itself when it lies there."""
    if isinstance(x, Mapping):
        return x[dev]
    where = x.cb1.device if isinstance(x, torch.nn.Module) else x.device
    if where != dev:
        raise ValueError(f"the {what} is on {where} but a shard is served "
                         f"on {dev}: pass replicate(devices, {what})")
    return x


def _on(dev: torch.device):
    """The device context kernels launch in (a no-op off the card)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _rank_shards(n_shards: int, group) -> list:
    """The shards this process serves: all of them, or with a process
    group, its contiguous run of n_shards / world (rank-major)."""
    if group is None:
        return list(range(n_shards))
    import torch.distributed as dist
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not divide over {world} "
                         "processes")
    per = n_shards // world
    return list(range(rank * per, (rank + 1) * per))


def _serve_cell(cfg, mode, k, n_intermediate, tree, sdb, c, queries,
                bin_offset):
    """One shard's core on one cell: (ids, dists, n_candidates)."""
    occ = None if sdb.pair_occ is None else sdb.pair_occ[c]
    if mode == "exact":
        return query_core_exact(cfg, tree, sdb.prefix2[c], sdb.payload[c],
                                sdb.vectors[c], queries, k,
                                bin_offset=bin_offset, pair_occ=occ)
    if mode == "big":
        return query_big_core(cfg, tree, sdb.prefix[c], sdb.counts[c],
                              sdb.payload[c], queries, k, n_intermediate,
                              bin_offset=bin_offset)
    if cfg.pair_pipeline_enabled:
        return query_core_pair(cfg, tree, sdb.prefix2[c], sdb.payload[c],
                               queries, k, bin_offset=bin_offset,
                               pair_occ=occ)
    return query_core(cfg, tree, sdb.prefix[c], sdb.counts[c],
                      sdb.payload[c], queries, k, bin_offset=bin_offset,
                      pair_occ=occ)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x, concatenated in rank order on axis 0."""
    import torch.distributed as dist
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return torch.cat(out)


def _cell_groups(cell_devs) -> dict:
    """{device: its cells}, devices in the order of their first cell: one
    graph each in the graphed step."""
    groups = {}
    for c, d in enumerate(cell_devs):
        groups.setdefault(d, []).append(c)
    return groups


def _in_cell_order(groups: dict, per_device) -> list:
    """The results of each device's cells (per_device, in `groups`' order)
    laid out by cell."""
    out = [None] * sum(len(cells) for cells in groups.values())
    for cells, got in zip(groups.values(), per_device):
        for c, x in zip(cells, got):
            out[c] = x
    return out


def make_sharded_query_fn(cfg: PQTConfig, devices, k: int,
                          mode: str = "line", n_intermediate: int = 256,
                          batch_split: int = 1, group=None):
    """The sharded query step: fn(tree, sdb, queries) -> QueryResult.

    `devices` is the shard-major grid of S * batch_split cells; with
    `group`, the grid over every process (for batch_split 1,
    `distributed.global_device_mesh`), of which `sdb` holds the cells of
    this rank's shards.  queries (B, dim), B a
    multiple of batch_split; the result's tensors lie on the first cell's
    device of this process, equal on every rank.

    mode: "line" (the line-code re-rank, the pair or parts pipeline by
    cfg), "exact" (every gathered candidate ranked by its true distance
    from the shard's raw vectors in CSR order; needs sdb.vectors) or "big"
    (the BIG two-stage enumeration with line re-rank, n_intermediate).

    On CUDA queries the step is served as CUDA graphs (utils/graphs.py),
    the counterpart of the JAX package's jax.jit over shard_map: the first
    call of a key runs the eager body and captures one graph for each
    distinct device of this process's cells, holding the cores of the
    cells there, and one for the merge on the first cell's device (with
    `group`, the all_gather and all_reduce inside it); later calls copy
    the queries in, replay and return fresh tensors.  The key is the
    step's fixed values with the queries' shape, dtype and device (of each
    replica) and every tensor of `tree` and `sdb` by address (a mapping by
    its items); the cache lives in the step, as the JAX package's
    `mapped_cache`.  The host checks (exact without vectors, the grid, the
    batch split) and, with `group`, the refusal of a poisoned runtime run
    on every call, before any replay.  `step.__wrapped__` is the eager
    body, `step.graphs` the entries by key (clearing it frees their pools;
    clear it before destroying `group`) and `step.graph_key(tree, sdb,
    queries)` a call's key.  CPU queries run the eager body.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    devices = _devices(devices)
    if batch_split < 1 or not devices or len(devices) % batch_split:
        raise ValueError(f"{len(devices)} devices do not form a grid of "
                         f"{batch_split} batch slices")
    J = batch_split
    n_shards = len(devices) // J
    if cfg.hash_size % n_shards:
        raise ValueError(f"hash_size {cfg.hash_size} does not divide into "
                         f"{n_shards} shards")
    span = cfg.hash_size // n_shards
    fixed = ("sharded", cfg, mode, k, n_intermediate, J, tuple(devices),
             group)

    def check(tree, sdb: ShardedDatabase, queries):
        """The host checks: (this process's shards, its cells' devices)."""
        if group is not None and not graphs._group_alive(group):
            raise RuntimeError("the sharded step's process group has been "
                               "destroyed")
        if mode == "exact" and sdb.vectors is None:
            raise ValueError("mode='exact' needs a ShardedDatabase built "
                             "from a db with keep_vectors=True")
        shards = _rank_shards(n_shards, group)
        cell_devs = [devices[s * J + j] for s in shards for j in range(J)]
        if len(sdb.prefix) != len(cell_devs):
            raise ValueError(f"the sharded database has {len(sdb.prefix)} "
                             f"cells; this process serves {len(cell_devs)}")
        for c, d in enumerate(cell_devs):
            if sdb.prefix[c].device != d:
                raise ValueError(f"cell {c} of the database is on "
                                 f"{sdb.prefix[c].device}, the grid puts "
                                 f"it on {d}")
        B = _replica(queries, cell_devs[0], "queries").shape[0]
        if B % J:
            raise ValueError(f"batch {B} does not divide into {J} slices")
        return shards, cell_devs

    def serve_cells(dev, tree, sdb, queries, shards, cells):
        """The cores of `cells`, all on `dev`: [(ids, dists, n_cand)]."""
        bs = queries.shape[0] // J
        lists = []
        with _on(dev):
            for c in cells:
                s, j = shards[c // J], c % J
                lists.append(_serve_cell(
                    cfg, mode, k, n_intermediate, tree, sdb, c,
                    queries[j * bs:(j + 1) * bs], s * span))
        return lists

    def merge(merge_dev, n_local, lists) -> QueryResult:
        """The cells' lists (cell order) merged on `merge_dev`."""
        with _on(merge_dev):
            local = torch.stack([
                torch.stack([ids, dists.contiguous().view(torch.int32)])
                .to(merge_dev, non_blocking=True)
                for ids, dists, _ in lists])          # (L*J, 2, bs, k')
            bs, kk = local.shape[-2:]
            local = local.view(n_local, J, 2, bs, kk)
            n_cand = torch.stack([nc.to(merge_dev, non_blocking=True)
                                  for _, _, nc in lists]).view(
                n_local, J, bs).sum(0)
            if group is not None:
                import torch.distributed as dist
                from pqt_tpu_torch.parallel import distributed
                distributed.refuse_if_poisoned("the sharded query's "
                                               "all_gather")
                local = _all_gather(local, group)     # (S, J, 2, bs, k')
                dist.all_reduce(n_cand, group=group)
            out_ids, out_d = [], []
            for j in range(J):
                flat_ids = local[:, j, 0].permute(1, 0, 2).reshape(
                    bs, n_shards * kk)
                flat_d = local[:, j, 1].view(torch.float32).permute(
                    1, 0, 2).reshape(bs, n_shards * kk)
                ids, dists = _top_ids(flat_d, flat_ids, k)
                out_ids.append(ids)
                out_d.append(dists)
            return QueryResult(indices=torch.cat(out_ids),
                               dists=torch.cat(out_d),
                               n_candidates=n_cand.reshape(J * bs))

    def run(tree, sdb, queries, shards, cell_devs) -> QueryResult:
        groups = _cell_groups(cell_devs)
        per_device = [            # launch on every device, wait for none
            serve_cells(d, _replica(tree, d, "tree"), sdb,
                        _replica(queries, d, "queries"), shards, cells)
            for d, cells in groups.items()]
        return merge(cell_devs[0], len(shards),
                     _in_cell_order(groups, per_device))

    def stages(tree, sdb, shards, cell_devs) -> list:
        """One stage a device of the cells, then the merge."""
        groups = _cell_groups(cell_devs)
        return [graphs.Stage(d, serve_cells, lambda q, _, d=d, cells=cells: (
                    d, _replica(tree, d, "tree"), sdb, q[d], shards, cells))
                for d, cells in groups.items()] + [
            graphs.Stage(cell_devs[0], merge, lambda q, outs: (
                cell_devs[0], len(shards), _in_cell_order(groups, outs)))]

    def key_of(tree, sdb, queries, cell_devs) -> tuple:
        replicas = ((d, _replica(queries, d, "queries"))
                    for d in _cell_groups(cell_devs))
        return (fixed, ("queries",) + tuple(
                    (d, tuple(q.shape), q.dtype) for d, q in replicas),
                graphs._leaves(tree), graphs._leaves(sdb))

    def query_fn(tree, sdb: ShardedDatabase, queries) -> QueryResult:
        return run(tree, sdb, queries, *check(tree, sdb, queries))

    cache, lock = {}, threading.Lock()

    @functools.wraps(query_fn)
    def step(tree, sdb: ShardedDatabase, queries) -> QueryResult:
        shards, cell_devs = check(tree, sdb, queries)
        if not graphs._served(_replica(queries, cell_devs[0], "queries")):
            return run(tree, sdb, queries, shards, cell_devs)
        if group is not None:
            from pqt_tpu_torch.parallel import distributed
            distributed.refuse_if_poisoned("the sharded query's all_gather")
        return graphs.replay_or_capture(
            cache, lock, key_of(tree, sdb, queries, cell_devs),
            {d: _replica(queries, d, "queries")
             for d in _cell_groups(cell_devs)},
            lambda: run(tree, sdb, queries, shards, cell_devs),
            lambda: stages(tree, sdb, shards, cell_devs), group)

    step.graphs = cache
    step.graph_key = lambda tree, sdb, queries: key_of(
        tree, sdb, queries, check(tree, sdb, queries)[1])
    return step


# ---------------------------------------------------------------------------
# Data-parallel building blocks: the encode and one k-means step
# ---------------------------------------------------------------------------

def _tree_on(tree, dev: torch.device):
    """The tree on `dev`: itself when it lies there, else a copy."""
    if tree.cb1.device == dev:
        return tree
    return type(tree)(*(getattr(tree, b).to(dev) for b in
                        ("cb1", "cb2", "centroids_full", "pair_dists")))


def make_dp_encode_fn(cfg: PQTConfig, devices, encode_chunk: int = 65536):
    """Data-parallel database encoding: fn(tree, data) -> (bins (n,) int32,
    codes (n, line_parts), t3 (n,) float32) in row order, on the first
    device.

    The rows go to the devices in contiguous runs of whole encode chunks
    (`encode_chunk` rows, build_database's default), each encoded as
    build_database encodes that chunk, so bins, codes and t3 equal the
    build's encode to the bit.  data: (n, dim) host array or tensor;
    uint8 rows go up raw and are cast on the device.  Each chunk is one
    call of `models.db.chunk_codes`, on a card a replay of its graph for
    the chunk's shape on that device.  The tree is copied to each other
    device once and kept while the same tree is given, so the copies'
    addresses, which those graphs read, stay put.
    """
    devices = _devices(devices)
    replicas = {}       # device: (the tree copied, its copy there)

    def tree_on(tree, d):
        got = replicas.get(d)
        if got is None or got[0] is not tree:
            got = replicas[d] = (tree, _tree_on(tree, d))
        return got[1]

    def encode_fn(tree, data):
        n = data.shape[0]
        starts = list(range(0, n, encode_chunk))
        per = -(-len(starts) // len(devices))
        parts = []
        for i, d in enumerate(devices):      # launch on every device first
            with _on(d):
                t = tree_on(tree, d)
                for s in starts[i * per:(i + 1) * per]:
                    x = torch.as_tensor(data[s:s + encode_chunk]).to(d)
                    parts.append(chunk_codes(cfg, t, x))
        first = devices[0]
        return tuple(torch.cat([p[i].to(first, non_blocking=True)
                                for p in parts]) for i in range(3))

    return encode_fn


def make_dp_kmeans_step(devices, group=None):
    """One data-parallel Lloyd E+M step: fn(data, centroids) -> centroids
    (k, d) float32 on the first device.

    The rows are split over the devices; each makes its partial per-cluster
    sums (one-hot^T @ x, as the JAX package) and counts, which are summed
    over the devices and, with `group`, over the processes by an
    all-reduce.  A cluster left empty keeps its centroid.

    On a card the step is served as the sharded query step is (utils/
    graphs.py): one graph a distinct device, holding the partials of its
    entries, and one for the merge on the first device (with `group`, the
    all-reduces inside it).  The centroids are copied in on every call;
    rows of a `data` tensor that lies on an entry's device are read where
    they lie (the key holds data's address), other rows (a host array, or
    rows on another device) are copied to the device first and then into
    the stage's buffer.  `step.__wrapped__` is the eager body,
    `step.graphs` the entries by key (clear it before destroying
    `group`).  On the CPU the step runs its eager body.
    """
    from pqt_tpu_torch.ops.distance import pairwise_sqdist
    devices = _devices(devices)
    first = devices[0]

    def spans(n) -> list:
        """(device, first row, end) of each entry with rows, in order."""
        rows = np.array_split(np.arange(n), len(devices))
        return [(d, int(r[0]), int(r[-1]) + 1)
                for d, r in zip(devices, rows) if len(r)]

    def lies_on(data, d) -> bool:
        return isinstance(data, torch.Tensor) and data.device == d

    def partials(dev, centroids, xs) -> list:
        """(sums, counts) of each row block of xs, on `dev`."""
        out = []
        with _on(dev):
            c = centroids.to(dev).to(torch.float32)
            for x in xs:
                x = x.to(dev).to(torch.float32)
                a = torch.argmin(pairwise_sqdist(x, c), dim=-1)
                onehot = (a[:, None] == torch.arange(
                    c.shape[0], device=dev)).to(torch.float32)
                out.append((onehot.T @ x, onehot.sum(0)))
        return out

    def merge(parts, centroids):
        with _on(first):
            sums = sum(p[0].to(first, non_blocking=True) for p in parts)
            counts = sum(p[1].to(first, non_blocking=True) for p in parts)
            if group is not None:
                import torch.distributed as dist
                from pqt_tpu_torch.parallel import distributed
                distributed.refuse_if_poisoned("the k-means all_reduce")
                dist.all_reduce(sums, group=group)
                dist.all_reduce(counts, group=group)
            cents = centroids.to(first).to(torch.float32)
            return torch.where(counts[:, None] > 0,
                               sums / torch.clamp_min(counts, 1.0)[:, None],
                               cents)

    def kmeans_step(data, centroids):
        sp = spans(data.shape[0])
        groups = _cell_groups([d for d, _, _ in sp])
        centroids = torch.as_tensor(centroids)
        per_device = [partials(d, centroids, [
            torch.as_tensor(data[sp[e][1]:sp[e][2]]) for e in es])
            for d, es in groups.items()]
        return merge(_in_cell_order(groups, per_device), centroids)

    def inputs(data, centroids, sp, groups) -> dict:
        """{device: (centroids, the rows copied in)} on each device."""
        return {d: (torch.as_tensor(centroids).to(d),) + tuple(
                    torch.as_tensor(data[sp[e][1]:sp[e][2]]).to(d)
                    for e in es if not lies_on(data, d))
                for d, es in groups.items()}

    def stages(data, sp, groups) -> list:
        def rows(d, es, copied):
            return ([data[sp[e][1]:sp[e][2]] for e in es]
                    if lies_on(data, d) else list(copied))
        return [graphs.Stage(d, partials, lambda q, _, d=d, es=es: (
                    d, q[d][0], rows(d, es, q[d][1:])))
                for d, es in groups.items()] + [
            graphs.Stage(first, merge, lambda q, outs: (
                _in_cell_order(groups, outs), q[first][0]))]

    cache, lock = {}, threading.Lock()

    @functools.wraps(kmeans_step)
    def step(data, centroids):
        if not graphs._served(first) or data.shape[0] == 0:
            return kmeans_step(data, centroids)
        if group is not None:
            if not graphs._group_alive(group):
                raise RuntimeError("the k-means step's process group has "
                                   "been destroyed")
            from pqt_tpu_torch.parallel import distributed
            distributed.refuse_if_poisoned("the k-means all_reduce")
        sp = spans(data.shape[0])
        groups = _cell_groups([d for d, _, _ in sp])
        ins = inputs(data, centroids, sp, groups)
        key = (("dp_kmeans", tuple(devices), group),
               graphs._leaves(data) if isinstance(data, torch.Tensor) else
               ("host", tuple(data.shape), str(data.dtype)),
               tuple((d, tuple((tuple(x.shape), x.dtype) for x in v))
                     for d, v in ins.items()))
        return graphs.replay_or_capture(
            cache, lock, key, ins, lambda: kmeans_step(data, centroids),
            lambda: stages(data, sp, groups), group)

    step.graphs = cache
    return step
