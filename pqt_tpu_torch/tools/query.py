"""CLI: batch-query a built database; report throughput and recall.

Port of pqt_tpu/tools/query.py (the reference's tool_query and the recall
analysis of its tests): it loads the tree and the database (either
package's artifacts) onto --device, a spilled database's sidecar leaves
uploaded once at load, and serves the queries in batches through line,
exact (--exact-rerank) or refine (--refine) query_knn.  With --sharded N
the database is loaded on the host instead (a spilled one's sidecars as
memmaps), split into N hash-range shards there, each shard put on its own
device -- cards 0..N-1 with --device cuda, the CPU N times with --device
cpu -- and served in line or exact mode with the per-shard top-k lists
merged (parallel/sharded.py).  The clock stops after the card has
finished the last batch.

Usage:
  python -m pqt_tpu_torch.tools.query --basename out/sift1m --dim 128 \
      --queries sift_query.fvecs [--groundtruth sift_gt.ivecs] [--k 100] \
      [--device cuda] [--sharded N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _as_float32(x: np.ndarray) -> np.ndarray:
    from pqt_tpu_torch.io import native
    if x.dtype == np.uint8:
        return native.u8_to_f32(x)
    return np.ascontiguousarray(x, np.float32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--basename", required=True)
    ap.add_argument("--queries", required=True)
    ap.add_argument("--groundtruth", default=None, help=".ivecs exact NNs")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--c1", type=int, default=16)
    ap.add_argument("--c2", type=int, default=16)
    ap.add_argument("--lineparts", type=int, default=16)
    ap.add_argument("--hashsize", type=int, default=1 << 22)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--k1", type=int, default=8, help="L1 probe width W")
    ap.add_argument("--maxbins", type=int, default=4096)
    ap.add_argument("--candidates", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4096, help="query chunk")
    ap.add_argument("--exact-rerank", action="store_true",
                    help="re-rank candidates with exact distances "
                         "(requires --keep-vectors at build)")
    ap.add_argument("--refine", action="store_true",
                    help="two-stage line -> exact refine (in-RAM and "
                         "spilled databases)")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="serve from a hash-range-sharded database over N "
                         "devices with merged per-shard top-k")
    ap.add_argument("--device", default="cuda",
                    help="device the database is loaded on and served from")
    return ap.parse_args(argv)


def load_runner(args: argparse.Namespace, dev):
    """The database loaded on `dev` for `args` (on the host with
    --sharded), and the function that serves one batch of queries with it
    (float32 (B, dim) -> ids (B, k))."""
    from pqt_tpu_torch.config import PQTConfig
    from pqt_tpu_torch.io import artifacts
    from pqt_tpu_torch.models.query import query_knn, query_knn_refine
    from pqt_tpu_torch.tools.create_db import artifact_paths

    cfg = PQTConfig(dim=args.dim, p=args.p, c1=args.c1, c2=args.c2,
                    line_parts=args.lineparts, hash_size=args.hashsize,
                    k1_query=min(args.k1, args.c1),
                    k1_build=min(16, args.c1), max_bins=args.maxbins,
                    max_candidates=args.candidates)
    paths = artifact_paths(args.basename, cfg)
    if args.sharded and args.refine:
        raise SystemExit("--refine is not available with --sharded "
                         "(sharded modes: line, or exact via "
                         "--exact-rerank)")
    tree = artifacts.load_tree(paths["tree"], cfg, dev)
    if args.sharded:
        return _sharded_runner(args, cfg, tree, paths["db"], dev)
    db = artifacts.load_database(paths["db"], cfg, dev)
    if args.refine:
        def run(q):
            return query_knn_refine(cfg, tree, db, q, args.k).indices
    else:
        def run(q):
            return query_knn(cfg, tree, db, q, args.k,
                             args.exact_rerank).indices
    return db, run


def _sharded_runner(args, cfg, tree, db_path: str, dev):
    """The database on the host, split into args.sharded shards there and
    each put on its device: cards 0..N-1 on the card (N must not exceed
    the cards visible), the CPU N times on the CPU."""
    import torch

    from pqt_tpu_torch.io import artifacts
    from pqt_tpu_torch.parallel.distributed import replicate
    from pqt_tpu_torch.parallel.sharded import (make_sharded_query_fn,
                                                place_sharded_db,
                                                shard_database)
    n = args.sharded
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < n:
            raise SystemExit(f"--sharded {n} needs that many devices; "
                             f"{visible} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = [dev] * n
    db = artifacts.load_database_host(db_path, cfg)
    sdb = place_sharded_db(shard_database(cfg, db, n), devices)
    qfn = make_sharded_query_fn(
        cfg, devices, args.k, mode="exact" if args.exact_rerank else "line")
    trees = replicate(devices, tree)

    def run(q):
        return qfn(trees, sdb, replicate(devices, q)).indices
    return db, run


def main(argv=None):
    args = parse_args(argv)

    import torch

    from pqt_tpu_torch.io.texmex import read_dataset
    from pqt_tpu_torch.utils.device import resolve_device
    from pqt_tpu_torch.utils.metrics import intersection_at, recall_at

    dev = resolve_device(args.device)
    db, run = load_runner(args, dev)
    print(f"database: {db.n_vectors} vectors")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    queries = torch.as_tensor(_as_float32(read_dataset(args.queries)),
                              device=dev)
    n_q = queries.shape[0]
    batch = min(args.batch, n_q)
    run(queries[:batch])                          # warm-up
    sync()
    t0 = time.time()
    results = [run(queries[s:s + batch]) for s in range(0, n_q, batch)]
    sync()
    dt = time.time() - t0
    ids = torch.cat(results).cpu().numpy()
    print(f"{n_q} queries in {dt:.3f}s -> {n_q / dt:.0f} QPS, "
          f"{dt / n_q * 1000:.3f} ms/query")

    if args.groundtruth:
        gt = np.asarray(read_dataset(args.groundtruth))
        rec = recall_at(ids, gt, ks=(1, 10, 100))
        inter = intersection_at(ids, gt, ks=(10, 100))
        print("recall:", {**rec, **inter})


if __name__ == "__main__":
    main()
