#!/usr/bin/env python3
"""Recall of the JAX package (pqt_tpu) on the CPU, on chip_smoke.py's SIFT1M
fixture and budget: the references the port's BIG, parts, split, multi-DB,
command-line and sharded paths are held to there.

Run from the repository root (needs JAX; takes some minutes and a few GiB
of host RAM):

    JAX_PLATFORMS=cpu python3 jax_cpu_reference.py [--json PATH]

It makes chip_smoke.py's fixture (1M SIFT-like uint8 vectors and 1024
held-out queries, seed 0), trains the JAX package's tree on the first 200k
with chip_smoke.py's config (SIFT1M_CONFIG, hash 2^20, 512 bins, 1024
candidates, pair_top_m 128, 8 k-means iterations on a 100k subsample),
builds the database of all 1M with raw vectors and the pair-occupancy
table, and serves the queries in batches of 256, k = 100, through
`query_big_knn` (n_intermediate 256) and `query_big_knn_perfect`
(refine_factor 8), and through the parts pipeline with the pair filter
(exact and line `query_knn`, `query_candidates`), in rows and in slab
mode (32 rows a slab).  It also runs the split tree (trained on the first
200k with percent 0.3, every vector routed by `mark_dense_vectors_for`,
both members with raw vectors; `query_knn_split` line, exact and refine),
the multi-database engine over the pair path's tree (group_parts 2, raw
vectors, the pair filter on; `query_multi_knn` occurrence and distance
line and exact), and the JAX package's own command lines with
chip_smoke.py's arguments (`cli_args`: convert, create_db --mode full,
query --exact-rerank --groundtruth) in a temporary directory, and the
database split into 4 hash-range shards on 4 virtual CPU devices
(`shard_database`, `make_sharded_query_fn` in line, exact and big mode,
n_intermediate 256; XLA_FLAGS asks for the devices before JAX is
imported).  It prints R@1, R@10 and the top-10 intersection of each (the
query tool: what it printed), and the candidate recall, against an exact
float64 brute force.
The JAX package trains with its own random draws, so its tree is not the
port's; the numbers are the level the port should reach, not its bits.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from chip_smoke import (BATCH, K, N_DB, N_QUERIES, N_TRAIN, cli_args,
                        cli_recall, make_queries, make_sift_like, run_main,
                        write_cli_files)


def exact_knn(queries: np.ndarray, data: np.ndarray, k: int) -> np.ndarray:
    """Ids of the k nearest rows of data for each query, float64."""
    q = queries.astype(np.float64)
    qn = (q * q).sum(1)
    best_d = np.full((len(q), 0), np.inf)
    best_i = np.zeros((len(q), 0), np.int64)
    for s in range(0, len(data), 1 << 16):
        x = data[s:s + (1 << 16)].astype(np.float64)
        d = qn[:, None] - 2.0 * q @ x.T + (x * x).sum(1)[None, :]
        d = np.concatenate([best_d, d], 1)
        i = np.concatenate([best_i, np.arange(s, s + len(x))[None, :]
                            .repeat(len(q), 0)], 1)
        top = np.argsort(d, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(d, top, 1)
        best_i = np.take_along_axis(i, top, 1)
    return best_i


def cli_exact(data, queries, gt):
    """The JAX package's convert, create_db and query mains over the
    fixture with chip_smoke.py's arguments: the recall query printed."""
    from pqt_tpu.io import texmex
    from pqt_tpu.tools import convert, create_db, query
    with tempfile.TemporaryDirectory(prefix="pqt_jax_cli_") as d:
        write_cli_files(texmex, d, data, queries, gt)
        conv, create, serve_args = cli_args(d)
        t0 = time.perf_counter()
        run_main(convert.main, conv)
        run_main(create_db.main, create)
        print(f"cli convert + create_db {time.perf_counter() - t0:.1f} s",
              flush=True)
        metrics, _ = cli_recall(run_main(query.main, serve_args))
    return {key[len("exact_"):]: v for key, v in metrics.items()}


N_SHARDS = 4


def main(json_path=None):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={N_SHARDS}"
            .strip())
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import pqt_tpu as P
    from pqt_tpu.models.query import query_candidates
    from pqt_tpu.models.multidb import build_multi_database, query_multi_knn
    from pqt_tpu.models.query_big import query_big_knn, query_big_knn_perfect
    from pqt_tpu.models.split import build_split_database, query_knn_split
    from pqt_tpu.utils.metrics import (candidate_recall, intersection_at,
                                       recall_at)

    cfg = P.SIFT1M_CONFIG.replace(
        kmeans_iters=8, train_subsample=100_000, hash_size=1 << 20,
        max_bins=512, max_candidates=1024, pair_top_m=128, enum_width=512,
        pair_filter=False)
    rng = np.random.default_rng(0)
    data, subcenters = make_sift_like(N_DB, cfg.dim, rng)
    queries = make_queries(N_QUERIES, subcenters, rng)
    t0 = time.perf_counter()
    tree = P.train_tree(cfg, data[:N_TRAIN])
    print(f"train {time.perf_counter() - t0:.1f} s", flush=True)
    gt = exact_knn(queries, data, K)
    db = P.build_database(cfg.replace(pair_filter=True), tree, data,
                          keep_vectors=True, encode_chunk=16384)
    parts = cfg.replace(pipeline="parts", pair_filter=True)
    slabs = parts.replace(gather_mode="slabs", slab_size=32)
    modes = {"big_line": lambda x: query_big_knn(cfg, tree, db, x, K, 256),
             "big_perfect": lambda x: query_big_knn_perfect(
                 cfg, tree, db, x, K, 8, 256)}
    for name, c in (("parts", parts), ("parts_slabs", slabs)):
        modes[f"{name}_exact"] = (
            lambda x, c=c: P.query_knn(c, tree, db, x, K, True))
        modes[f"{name}_line"] = (
            lambda x, c=c: P.query_knn(c, tree, db, x, K))
        modes[f"{name}_candidates"] = (
            lambda x, c=c: query_candidates(c, tree, db, x))
    t0 = time.perf_counter()
    sdb = build_split_database(cfg, data, 0.3, keep_vectors=True,
                               encode_chunk=16384, train_data=data[:N_TRAIN])
    print(f"split build {time.perf_counter() - t0:.1f} s, dense share "
          f"{sdb.dense_ids.shape[0] / N_DB:.4f}", flush=True)
    modes["split_line"] = lambda x: query_knn_split(cfg, sdb, x, K)
    modes["split_exact"] = lambda x: query_knn_split(cfg, sdb, x, K, True)
    modes["split_refine"] = lambda x: query_knn_split(cfg, sdb, x, K,
                                                      False, True)
    t0 = time.perf_counter()
    mdb = build_multi_database(cfg, tree, data, 2, encode_chunk=16384,
                               keep_vectors=True)
    print(f"multidb build {time.perf_counter() - t0:.1f} s", flush=True)
    mcfg = cfg.replace(pair_filter=True)
    modes["multidb_occurrence"] = lambda x: query_multi_knn(
        mcfg, tree, mdb, x, K)
    modes["multidb_distance"] = lambda x: query_multi_knn(
        mcfg.replace(multidb_rank="distance"), tree, mdb, x, K)
    modes["multidb_exact"] = lambda x: query_multi_knn(mcfg, tree, mdb, x,
                                                       K, True)
    from jax.sharding import Mesh
    from pqt_tpu.parallel import sharded
    mesh = Mesh(np.array(jax.devices()[:N_SHARDS]), ("db",))
    shards = sharded.place_sharded_db(
        sharded.shard_database(cfg, db, N_SHARDS), mesh)
    for mode in ("line", "exact", "big"):
        fn = sharded.make_sharded_query_fn(cfg, mesh, K, mode=mode,
                                           n_intermediate=256)
        modes[f"sharded_{mode}"] = lambda x, fn=fn: fn(tree, shards, x)
    out = {}
    for name, fn in modes.items():
        res = [fn(jnp.asarray(queries[s:s + BATCH]))
               for s in range(0, N_QUERIES, BATCH)]
        if name.endswith("_candidates"):
            out[name] = {"candidate_recall": candidate_recall(
                np.concatenate([np.asarray(r[0]) for r in res]),
                np.concatenate([np.asarray(r[1]) for r in res]), gt)}
        else:
            ids = np.concatenate([np.asarray(r.indices) for r in res])
            out[name] = {**recall_at(ids, gt, (1, 10)),
                         **intersection_at(ids, gt, (10,))}
        print(name, json.dumps(out[name]), flush=True)
    out["cli_exact"] = cli_exact(data, queries, gt)
    print("cli_exact", json.dumps(out["cli_exact"]), flush=True)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH")
    main(ap.parse_args().json)
