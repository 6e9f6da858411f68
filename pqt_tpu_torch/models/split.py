"""The sparse/dense split-tree engine.

Port of pqt_tpu/models/split.py.  A split tree shares one L1 codebook and
keeps two sets of refinement codebooks: one trained on the densest L1 bins'
population (the vectors of the busiest bins holding `percent` of the
samples), one on the rest (`train_tree_split`).  Each population gets its
own database over LOCAL ids; the id maps turn them back into global ids.
A query runs the standard pipeline (line, exact or refine) against both
members, maps their ids through the maps (kernel E, a table lookup), and
merges the two k-lists by distance with kernel A: invalid slots are +inf,
and the dense member's list comes first, so distance ties keep the dense
result, as `lax.top_k` over the concatenation does.  The populations are
disjoint, so the merge needs no dedup.

Artifacts use the JAX package's names (`<path>.dense.tree`, `.sparse.tree`,
`.dense.db`, `.sparse.db` and the id maps in `<path>.ids.npz`), so each
package loads the other's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import PQTDatabase, build_database
from pqt_tpu_torch.models.query import (QueryResult, _top_ids, query_knn,
                                        query_knn_refine)
from pqt_tpu_torch.models.tree import (PQTree, mark_dense_vectors_for,
                                       train_tree_split)
from pqt_tpu_torch.ops.cuda.gather import lut_gather
from pqt_tpu_torch.utils.device import resolve_device
from pqt_tpu_torch.utils.graphs import graphed


class SplitDatabase(NamedTuple):
    """Two trees sharing L1 and two databases over disjoint populations;
    dense_ids / sparse_ids map each member's LOCAL vector id to the global
    id in the original dataset."""
    dense_tree: PQTree
    sparse_tree: PQTree
    dense_db: PQTDatabase
    sparse_db: PQTDatabase
    dense_ids: torch.Tensor      # (n_dense,) int32 global ids
    sparse_ids: torch.Tensor     # (n_sparse,) int32 global ids

    @classmethod
    def from_numpy(cls, cfg: PQTConfig, dense_cb, sparse_cb, dense_db,
                   sparse_db, dense_ids, sparse_ids,
                   device="cuda") -> "SplitDatabase":
        """A split database from host arrays, for example the JAX
        package's: dense_cb / sparse_cb are (cb1, cb2) pairs, dense_db /
        sparse_db dicts of PQTDatabase.from_numpy's arguments."""
        dev = resolve_device(device)
        return cls(
            dense_tree=PQTree.from_numpy(cfg, *dense_cb, device=dev),
            sparse_tree=PQTree.from_numpy(cfg, *sparse_cb, device=dev),
            dense_db=PQTDatabase.from_numpy(**dense_db, device=dev),
            sparse_db=PQTDatabase.from_numpy(**sparse_db, device=dev),
            dense_ids=torch.as_tensor(np.array(dense_ids, np.int32),
                                      device=dev),
            sparse_ids=torch.as_tensor(np.array(sparse_ids, np.int32),
                                       device=dev))


def build_split_database(cfg: PQTConfig, data, percent: float = 0.3,
                         keep_vectors: bool = False,
                         encode_chunk: int = 65536, train_data=None,
                         device="cuda") -> SplitDatabase:
    """Train a split tree on `train_data` (default `data`) and build both
    member databases on `device`.

    With `train_data`, the full dataset's membership is recomputed under
    the trained L1 (`mark_dense_vectors_for`).  Each member is built over
    its own population with LOCAL ids.
    """
    dev = resolve_device(device)
    data = np.asarray(data)
    dense_tree, sparse_tree, dense = train_tree_split(
        cfg, data if train_data is None else train_data, percent,
        device=dev)
    if train_data is not None:
        dense = mark_dense_vectors_for(cfg, dense_tree, data, percent)
    dm = dense.cpu().numpy()
    members = [build_database(cfg, tree, data[mask],
                              keep_vectors=keep_vectors,
                              encode_chunk=encode_chunk, device=dev)
               for tree, mask in ((dense_tree, dm), (sparse_tree, ~dm))]
    ids = [torch.as_tensor(np.flatnonzero(mask).astype(np.int32), device=dev)
           for mask in (dm, ~dm)]
    return SplitDatabase(dense_tree, sparse_tree, *members, *ids)


@graphed(static_argnums=(0, 3, 4, 5))
def query_knn_split(cfg: PQTConfig, sdb: SplitDatabase,
                    queries: torch.Tensor, k: int,
                    exact_rerank: bool = False,
                    refine: bool = False) -> QueryResult:
    """Union query over both members with global ids: `query_knn` (line
    or exact) or `query_knn_refine` against each (their eager bodies: on
    the card the whole union is one graph), ids mapped through the id
    maps, then one top-k of the concatenated (B, 2k) lists."""
    queries = queries.to(torch.float32)

    def one(tree, db, ids_map):
        if refine:
            r = query_knn_refine.__wrapped__(cfg, tree, db, queries, k)
        else:
            r = query_knn.__wrapped__(cfg, tree, db, queries, k,
                                      exact_rerank)
        live = r.indices >= 0
        local = torch.where(live, r.indices, 0).contiguous()
        return (torch.where(live, lut_gather(ids_map, local), -1), r.dists,
                r.n_candidates)

    gd, dd, nd = one(sdb.dense_tree, sdb.dense_db, sdb.dense_ids)
    gs, ds, ns = one(sdb.sparse_tree, sdb.sparse_db, sdb.sparse_ids)
    ids = torch.cat([gd, gs], dim=1)
    dists = torch.where(ids >= 0, torch.cat([dd, ds], dim=1), float("inf"))
    out_ids, out_d = _top_ids(dists.contiguous(), ids, k)
    return QueryResult(indices=out_ids, dists=out_d, n_candidates=nd + ns)


def save_split_database(path: str, cfg: PQTConfig,
                        sdb: SplitDatabase) -> None:
    """Persist every split artifact under one basename, in the JAX
    package's file names."""
    from pqt_tpu_torch.io import artifacts
    artifacts.save_tree(path + ".dense.tree", cfg, sdb.dense_tree)
    artifacts.save_tree(path + ".sparse.tree", cfg, sdb.sparse_tree)
    artifacts.save_database(path + ".dense.db", cfg, sdb.dense_db)
    artifacts.save_database(path + ".sparse.db", cfg, sdb.sparse_db)
    np.savez(path + ".ids.npz", dense_ids=sdb.dense_ids.cpu().numpy(),
             sparse_ids=sdb.sparse_ids.cpu().numpy())


def load_split_database(path: str, cfg: PQTConfig,
                        device="cuda") -> SplitDatabase:
    from pqt_tpu_torch.io import artifacts
    dev = resolve_device(device)
    with np.load(path + ".ids.npz") as z:
        ids = [torch.as_tensor(z[name].astype(np.int32), device=dev)
               for name in ("dense_ids", "sparse_ids")]
    return SplitDatabase(
        dense_tree=artifacts.load_tree(path + ".dense.tree", cfg, dev),
        sparse_tree=artifacts.load_tree(path + ".sparse.tree", cfg, dev),
        dense_db=artifacts.load_database(path + ".dense.db", cfg, dev),
        sparse_db=artifacts.load_database(path + ".sparse.db", cfg, dev),
        dense_ids=ids[0], sparse_ids=ids[1])
