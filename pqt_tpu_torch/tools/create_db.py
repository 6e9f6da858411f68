"""CLI: train a PQ tree and build a database from a dataset file.

Port of pqt_tpu/tools/create_db.py (the reference's tool_createdb): read the
vectors, train the tree (or load it), encode the database on the card and
save the artifacts, named `<basename>_<dim>_<p>_<c1>_<c2>.{tree,db}.npz` as
the JAX package names them, so either package's query tool reads them.

Modes: `full` (one process: chunked build, in RAM or spilled with --spill),
`encode` (one chunk file, --chunk-id, per worker) and `merge` (the chunk
files into the CSR database on the host, no device work).

Usage:
  python -m pqt_tpu_torch.tools.create_db --dataset sift_base.fvecs \
      --basename out/sift1m --p 4 --c1 16 --c2 16 [--chunksize 10000000] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from pqt_tpu_torch.io.texmex import dataset_header, read_dataset


def artifact_paths(basename: str, cfg) -> dict:
    stem = f"{basename}_{cfg.dim}_{cfg.p}_{cfg.c1}_{cfg.c2}"
    return {"tree": stem + ".tree.npz", "db": stem + ".db.npz"}


def read_train_sample(path: str, num: int, n_train: int,
                      n_blocks: int = 64) -> np.ndarray:
    """A training sample spread across the file: `n_blocks` contiguous
    blocks at evenly spaced offsets (the first n_train rows would skew the
    codebooks of an ordered file)."""
    if n_train >= num:
        return read_dataset(path, num)
    n_blocks = min(n_blocks, max(1, n_train // 1024))
    per = n_train // n_blocks
    stride = num // n_blocks
    return np.concatenate([read_dataset(path, per, i * stride)
                           for i in range(n_blocks)], axis=0)


def _save_tree_atomic(path: str, cfg, tree) -> None:
    """Write the tree to a temporary file, then rename it into place, so a
    concurrent reader never opens a half-written tree."""
    from pqt_tpu_torch.io import artifacts
    tmp = f"{path[:-len('.npz')]}.tmp{os.getpid()}.npz"
    artifacts.save_tree(tmp, cfg, tree)
    os.replace(tmp, path)


def _host(a) -> np.ndarray:
    return a if isinstance(a, np.ndarray) else a.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True,
                    help=".fvecs/.bvecs/.umem database vectors")
    ap.add_argument("--basename", required=True, help="artifact path stem")
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--c1", type=int, default=16)
    ap.add_argument("--c2", type=int, default=16)
    ap.add_argument("--lineparts", type=int, default=16)
    ap.add_argument("--hashsize", type=int, default=1 << 22,
                    help="inverted-file slots (power of two)")
    ap.add_argument("--chunksize", type=int, default=10_000_000,
                    help="vectors per build chunk")
    ap.add_argument("--train-size", type=int, default=2_000_000,
                    help="training sample, spread across the file")
    ap.add_argument("--keep-vectors", action="store_true",
                    help="store raw vectors for exact re-rank")
    ap.add_argument("--kmeans-iters", type=int, default=25)
    ap.add_argument("--spill", default=None, metavar="PATH",
                    help="out-of-core build: encoded chunks go through disk "
                         "and the database into memmaps at PATH, saved as "
                         "raw sidecars")
    ap.add_argument("--mode", choices=("full", "encode", "merge"),
                    default="full",
                    help="'encode' writes ONE chunk file (--chunk-id) and "
                         "exits; 'merge' assembles every chunk file into "
                         "the database on the host")
    ap.add_argument("--chunk-id", type=int, default=-1,
                    help="which chunk --mode encode encodes")
    ap.add_argument("--device", default="cuda",
                    help="device the tree trains and the chunks encode on")
    args = ap.parse_args(argv)

    from pqt_tpu_torch.config import PQTConfig
    from pqt_tpu_torch.io import artifacts
    from pqt_tpu_torch.models.db import (ChunkedDBBuilder,
                                         encode_chunk_to_file,
                                         merge_chunk_files)
    from pqt_tpu_torch.models.tree import train_tree
    from pqt_tpu_torch.utils.device import resolve_device
    from pqt_tpu_torch.utils.metrics import occupancy_histogram

    dev = resolve_device(args.device)
    num, dim = dataset_header(args.dataset)
    cfg = PQTConfig(dim=dim, p=args.p, c1=args.c1, c2=args.c2,
                    line_parts=args.lineparts, hash_size=args.hashsize,
                    kmeans_iters=args.kmeans_iters,
                    k1_build=min(16, args.c1), k1_query=min(8, args.c1))
    paths = artifact_paths(args.basename, cfg)
    os.makedirs(os.path.dirname(paths["tree"]) or ".", exist_ok=True)

    if os.path.exists(paths["tree"]):
        print(f"loading tree from {paths['tree']}")
        tree = artifacts.load_tree(paths["tree"], cfg, dev)
    else:
        n_train = min(num, args.train_size)
        print(f"training tree on {n_train} vectors "
              f"(sampled across the file) ...")
        t0 = time.time()
        tree = train_tree(cfg, read_train_sample(args.dataset, num, n_train),
                          device=dev)
        print(f"trained in {time.time() - t0:.1f}s")
        _save_tree_atomic(paths["tree"], cfg, tree)

    stem = paths["db"][:-len(".db.npz")]
    n_chunks = -(-num // args.chunksize)
    if args.mode == "encode":
        i = args.chunk_id
        if not 0 <= i < n_chunks:
            raise SystemExit(f"--chunk-id must be in [0, {n_chunks})")
        off = i * args.chunksize
        n_chunk = min(args.chunksize, num - off)
        t0 = time.time()
        out = f"{stem}.chunk{i}.npz"
        encode_chunk_to_file(cfg, tree, read_dataset(args.dataset, n_chunk,
                                                     off),
                             off, out, keep_vectors=args.keep_vectors,
                             device=dev)
        print(f"encoded chunk {i}/{n_chunks} ({n_chunk} vectors) -> {out} "
              f"in {time.time() - t0:.1f}s")
        return

    if args.mode == "merge":
        chunk_paths = [f"{stem}.chunk{i}.npz" for i in range(n_chunks)]
        missing = [p for p in chunk_paths if not os.path.exists(p)]
        if missing:
            raise SystemExit(f"missing chunk files: {missing[:3]}"
                             f"{'...' if len(missing) > 3 else ''}")
        t0 = time.time()
        db = merge_chunk_files(cfg, tree, chunk_paths,
                               keep_vectors=args.keep_vectors,
                               spill_path=args.spill or (stem + ".spill"),
                               to_device=False)
        print(f"merged {n_chunks} chunks / {db.n_vectors} vectors "
              f"in {time.time() - t0:.1f}s")
        print("occupancy:", occupancy_histogram(_host(db.counts)))
        artifacts.save_database(paths["db"], cfg, db, adopt_memmaps=True)
        print(f"saved {paths['tree']} and {paths['db']}")
        return

    t0 = time.time()
    builder = ChunkedDBBuilder(cfg, tree, keep_vectors=args.keep_vectors,
                               spill_path=args.spill, device=dev)
    for off in range(0, num, args.chunksize):
        n_chunk = min(args.chunksize, num - off)
        print(f"encoding chunk @{off} ({n_chunk} vectors)")
        builder.add_chunk(read_dataset(args.dataset, n_chunk, off))
    db = builder.finalize(to_device=not args.spill)
    print(f"built database of {db.n_vectors} vectors "
          f"in {time.time() - t0:.1f}s")
    print("occupancy:", occupancy_histogram(_host(db.counts)))
    artifacts.save_database(paths["db"], cfg, db,
                            adopt_memmaps=bool(args.spill))
    if args.spill:
        for p in glob.glob(args.spill + ".chunk*.npz"):
            os.remove(p)            # the builder's spilled chunks
    print(f"saved {paths['tree']} and {paths['db']}")


if __name__ == "__main__":
    main()
