#!/usr/bin/env python3
"""Drive the PyTorch port (pqt_tpu_torch) on one CUDA card, end to end.

Run from the repository root:  python3 chip_smoke.py [--json PATH]

Phases (any failure exits non-zero before the last line is printed):

  1. preconditions: a CUDA card; prints nvidia-smi's name and power limit
     and the TF32 flags the package sets;
  2. builds the hand-written CUDA kernels from pqt_tpu_torch/csrc (nvcc,
     one process per source, in parallel) and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes the query paths give it (top-k, prefix sums, lookups, row
     gathers and the exact re-rank's distances with integer-valued queries
     exact; the line re-rank by position, `gather_rerank`, ids exact and
     distances within rtol 1e-5, atol 1e-4, in the compact and the wide
     payload layout, and equal to the bit to its old route, kernel H's
     payload rows and then kernel C over them; segment sums of integer
     values exact, in
     plain mode and in square mode, the latter beside the old route of
     x * x then plain mode),
     and times kernel, plain version and the one PyTorch call computing the
     same function by their device time (torch.profiler; CUDA events,
     counted and printed, where no profiler session records device time),
     beside the launch floor (a one-element fill_).  The top-k, the prefix
     sums, the lookups, the row gathers, the segment sums and the exact
     distances also run at SIFT1B_CONFIG's widths (2^29-slot tables, the
     probe table's 4 GiB among them; the phase's peak device memory is
     printed), the top-k with kernel A's merge mode (32768 and 65536 kept
     of 65536-wide rows); the top-k rows above 16384 elements are timed
     beside torch.sort(stable) too, with each route of kernel A (one block
     a row, and a thread-block cluster of 4 and of 8 blocks a row) and,
     for the one-block route, how many times its passes read the row
     (worked out from the input); top-k and prefix
     sums run in the mode and route their wrapper picks and in every other
     mode and route that takes the shape (all held and timed), the prefix
     sums' onepass mode also captured in a CUDA graph and replayed on new
     inputs (each replay held, the replay timed beside the eager launch);
     kernel L, the build's line-code selection, at a 65536-row chunk's
     SIFT1M and SIFT1B widths (lp 16 and 32, c1 16) at both lambda widths,
     fed from the line GEMM's own output, codes and terms equal to the
     plain chain (the tables' passes, then line_codes_plain) to the bit (no
     PyTorch call computes it: "library" None), kernel P, the build's part
     codes, at a 65536-row chunk of the SIFT presets' part widths (p 4,
     256 centroids, vl 32) and of GIST's vl 240, each code that differs from
     the plain version's a near-tie, at most 1e-4 of them,
     the segment
     sums of the encode
     also over a rotating set of inputs larger than L2 (cold, beside the
     warm repeats), the lookups and row gathers with
     a sectors' bound beside the byte bound, the exact distances
     (`gather_sqdist`, kernels H and D fused) beside the five launches they
     replaced (H's rows, the float copy, the difference, the square and
     D's row sums), the line re-rank warm and cold (candidates drawn anew
     over rows read 256 MiB earlier) beside its old route, warm and cold;
     then the kernels are held on inputs that are hard for them (not
     timed; kernel L on coincident centroids, exact residual ties, lambda
     past and about both ends of [-4, 4), NaN and infinite distances,
     rows at centroids (distances clamped at 0), inf and NaN rows, ragged
     shapes, its loop route at other c1 and other strides, to the bit;
     kernel P on
     integer ties, rows on centroids, NaN and infinite values and zeros to
     the bit, on ragged rows, its loop route and an unaligned input at
     most a near-tie);
  4. the pair path at SIFT1M width: train a tree on 200k of bench.py's 1M
     SIFT-like vectors (seed 0), build the database of all 1M on the card
     (with the pair-occupancy table, which the pair path leaves unused),
     and serve 1024 held-out queries in batches of 256 through exact, line
     and refine query_knn and query_candidates; the train and the build
     run again through their eager bodies and must equal the replayed
     ones to the bit (trees, every database leaf, pair_occ included), and
     a train at the configuration's own kmeans_iters (30) on the 200k rows
     runs replayed and eager, and replayed again with each block of Lloyd
     steps between two reads of `done` (LLOYD_BLOCKS), every tree equal;
     the build's chunked upload (pinned slots, a copy stream) with and
     without raw vectors equals, in every leaf to the bit, a frozen copy
     of the body before it (`serial_build`: every row up first), and so
     do the other entries that stage rows through it (ChunkedDBBuilder,
     encode_chunk_to_file and their merge, build_multi_database) against
     frozen copies of theirs (`staged_entry_checks`);
  5. the parts path on the same tree and database: the parts pipeline with
     the pair filter through the same four entry points, then exact, line
     and query_candidates again with slab gathers (32 rows a slab);
  6. the BIG two-stage path on the same database, line (n_intermediate
     256) and perfect (refine_factor 8), each a path of its own; then the
     pair path's line mode over a rebuild with the wide payload, which
     must launch kernel C's wide mode;
  7. on the same fixture: the split tree (trained on the 200k rows with
     percent 0.3, all 1M routed by mark_dense_vectors_for, both members
     built with raw vectors; line, exact and refine query_knn_split; the
     artifacts saved and loaded, with results equal to those before; the
     dense share and both members' occupancy printed), the multi-database
     engine over the pair path's tree (group_parts 2, raw vectors, the
     pair filter on; occurrence and distance line and exact
     query_multi_knn; `_duplicate_stats` timed on one batch, and that
     batch's occurrence ranking equal to its plain route, stable
     torch.sort passes, to the bit), its rebuild
     with the payloads spilled to disk and placed on the card once (the
     bytes uploaded equal the payloads', serving copies none, the results
     equal the in-memory build's to the bit), and the command lines: the
     fixture written as .bvecs and an .ivecs exact top-100, `convert` to
     .umem, `create_db --mode full` at SIFT1M widths (hash 2^20) in chunks
     of 250k with raw vectors, and `query --exact-rerank --groundtruth`,
     its printed recall parsed, then `query --sharded 1`, whose printed
     recall must equal it to the last digit and whose batches must be
     served by replays of the sharded step's graphs;
  8. the sharded layer on the same fixture (parallel/): the pair path's
     database in 4 hash-range shards on the one card, line, exact and big
     at batch 256, each held 0.002 below the same mode on one device and
     0.03 below the JAX package's 4-shard CPU run; exact again with the
     batch in 2 slices over a (4, 2) grid of the card, equal to the bit;
     the data-parallel encode of the 1M vectors over 4 entries of the
     card, equal to the build's payload and counts to the bit; one
     data-parallel k-means step, within 1e-4 of the one-device step; both
     replayed (first call and again) and eager, equal to the bit; and
     the multi-process chain in a world of one NCCL rank (4 chunk files,
     merge_chunk_files_range, build_local_shards, place_host_sharded_db,
     peer_barrier, the exact query through the group, its all_gather and
     all_reduce captured in the merge's graph), equal to the in-process
     result to the bit, with the data-parallel k-means step through the
     group (its all_reduces in the merge's graph) equal to the step
     without one; the sharded steps' graphs are dropped before the
     group is destroyed;
  9. SIFT1B_CONFIG at full width over 10M vectors (a cut of SIFT1B's 10^9
     forced by the run time; the fixture scales its clusters with n as
     benchmarks/rehearsal_50m.py does): train on 200k, encode 2M-vector
     chunk files (the train and every chunk file again through the eager
     bodies, equal to the bit; encode_s split into the fixture's copy to
     the host and `encode_chunk_to_file`, with rows a second and a
     65536-row chunk's p50, replayed, eager and eager through kernel L's
     plain version, one chunk of each profiled; the replayed chunk's bins,
     part codes and payload rows equal to the plain route's to the bit;
     the chunked upload of 8M host rows held to `serial_build` as at
     SIFT1M width, and one build of them profiled: no pageable copy to
     the card, one pinned copy and one slot fill a chunk, every chunk
     staged, and the share of the copies' time that kernels overlap;
     `part_codes_checks` on the same rows, as at SIFT1M width after its
     upload checks: kernel P on a chunk against its plain version and
     timed beside its bound, and a build against the same build through
     the plain version, equal but at near-tie rows),
     merge them on the host into a spilled CSR database,
     save it with raw sidecars (adopting the spill files), load it onto
     the card, and serve 1024 queries in batches of 64 through exact and
     refine over vectors_csr, line, query_candidates, BIG line and BIG
     perfect (vectors by id attached on the card); kernel A's merge mode
     and its cluster route must launch; encode, merge, save and load
     seconds, bin occupancy, peak device memory and host RSS are printed;
     then, the single-device database freed, phase 8's chain over the same
     chunk files: 4 shards
     of 2^27 slots in a world of one NCCL rank, exact and line at batch
     64, held to the floors above and 0.002 below the single-device
     recall, with the range merge's seconds and the host peak RSS;
 10. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}.

The train and build side runs through its compiled programs
(models/db.py `chunk_encoder` and `chunk_codes`, models/kmeans.py's Lloyd
step and k-means++ pick, the data-parallel k-means step), one CUDA graph
a key; each key's capture seconds and pool are printed, and the graphs
are freed before the next serving.

Every path of 4-9 serves through the public entry points, which on the
card replay one CUDA graph a static key (pqt_tpu_torch/utils/graphs.py;
the sharded step of 8 and 9 one graph a device of its grid and one for
the merge, each key's stages printed), and again through their eager
bodies (`__wrapped__`) by the same protocol; both servings are printed (QPS, batch p50 / p90 / max, the
idle share of one profiled batch), with each path's graphs' capture
seconds and device memory.  The run fails unless, on every such path,
every replayed result equals the eager one to the bit (ids, distances,
n_candidates) over all the queries, one batch a mode replayed 200 times in
alternation with the path's other graphs (and, but at SIFT1B, the pair
path's line graph) equals its first replay every time, and the hand-written kernels in the
profiler trace of one replay, counted by name, equal the launch counts the
capture recorded for each wrapper.  Phase 4 also runs
`brute_force_knn_fast` once over the 1M vectors: its ids must equal the
oracle's wherever the distances are untied.

Every kernel launch count is reset just before each path (4, 5, the slab
variant of 5, each of 6, each serving of 7 and the command-line queries,
each sharded serving and the data-parallel encode of 8, and 9's serving
and its sharded serving) and read just after it; a kernel
of that path with no launch fails the run (`gather_sqdist` on every path
that serves exact, refine or BIG perfect), and so do launch counts or a
recall that differ from the reference run's (REFERENCE_LAUNCHES,
REFERENCE_RECALL).  Recall of every path is checked against an exact
float64 brute force on the card: the SIFT1M paths against their
thresholds (the BIG, split, multi-DB and command-line paths 0.03 below
the JAX package's recall on the CPU, the split and the command line never
below the pair path's thresholds, the wide payload's line top-10 at most
0.01 below the compact one's), the SIFT1B phase against its floors.  Each
path of 4-9 is profiled for one batch a mode, replayed and eager (device
busy ms, idle share).

Timings are the card's, with its name and power limit printed beside them.
"""

import bisect
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s, for each kernel's least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# bytes a rotating set of inputs spans, five times the H100's 50 MB L2: each
# call then reads an input that was last read 200 MB of traffic earlier
COLD_SET_BYTES = 256 << 20

# Round-5 recall of the JAX package on the same fixture and budget
# (BENCH_r05.json); recall depends on the algorithm, not on the chip.
ROUND5 = {"exact_R@1": 0.9854, "refine_R@1": 0.9854,
          "candidate_recall": 0.9863, "line_top10_intersection": 0.7188}
THRESHOLDS = {"exact_R@1": 0.95, "refine_R@1": 0.95,
              "candidate_recall": 0.95, "line_top10_intersection": 0.6}
# The JAX package's recall on the CPU for the same fixture, tree training
# and budget, with the parts pipeline and the pair filter (slack 1.5), in
# rows and in slab mode (refine was not run there; jax_cpu_reference.py).
JAX_CPU_PARTS = {"exact_R@1": 0.9893, "candidate_recall": 0.9893,
                 "line_top10_intersection": 0.7206}
JAX_CPU_SLABS = {"exact_R@1": 0.9893, "candidate_recall": 0.9893,
                 "line_top10_intersection": 0.7203}
# The JAX package's recall on the CPU for the same fixture, tree training
# and budget, on the BIG path (query_big_knn with n_intermediate 256, and
# query_big_knn_perfect with refine_factor 8; jax_cpu_reference.py); the
# port is held about 0.03 below it.
JAX_CPU_BIG = {"big_line_R@10": 0.8203, "big_line_top10_intersection": 0.7207,
               "big_perfect_R@1": 0.9902}
THRESHOLDS.update({key: round(v - 0.03, 4) for key, v in JAX_CPU_BIG.items()})


def _modes(**by_mode):
    return {f"{mode}_{key}": v for mode, metrics in by_mode.items()
            for key, v in metrics.items()}


# The JAX package's recall on the CPU for the same fixture and budget
# (jax_cpu_reference.py) on the split tree (query_knn_split line, exact and
# refine), the multi-database engine over its pair-path tree (group_parts
# 2, the pair filter on: occurrence and distance line, exact), and the JAX
# package's own convert, create_db and query mains with `cli_args` (exact;
# what its query printed).  Each path is held 0.03
# below it; the split and the command lines also never below the pair
# path's threshold of a metric.  The multi-DB exact re-rank reaches less
# than the pair path's (the JAX package's own 0.76 at this budget: two-part
# groups' coarse bins, 512 candidates a group), so it keeps the JAX floor.
JAX_CPU_SPLIT = _modes(
    line={"R@1": 0.1318, "R@10": 0.8164, "top10_intersection": 0.7246},
    exact={"R@1": 0.9863, "R@10": 0.9863, "top10_intersection": 0.9874},
    refine={"R@1": 0.9854, "R@10": 0.9863, "top10_intersection": 0.9874})
JAX_CPU_MULTIDB = _modes(
    occurrence={"R@1": 0.1152, "R@10": 0.5049, "top10_intersection": 0.4886},
    distance={"R@1": 0.1172, "R@10": 0.6846, "top10_intersection": 0.6322},
    exact={"R@1": 0.7637, "R@10": 0.7637, "top10_intersection": 0.7617})
JAX_CPU_CLI = _modes(exact={"R@1": 0.9893, "R@10": 0.9893, "R@100": 0.9893,
                            "top10_intersection": 0.9901,
                            "top100_intersection": 0.9825})
# The JAX package's recall on the CPU for the same fixture and budget with
# the database in 4 hash-range shards on 4 virtual devices
# (jax_cpu_reference.py: make_sharded_query_fn line, exact and big with
# n_intermediate 256).  Phase 8 holds each sharded mode 0.03 below it, and
# SHARDED_SLACK below the same mode's single-device recall on the same
# database and budget (a shard probes the whole budget in its own range, so
# the merged candidates only grow; the JAX tests require >= on their
# fixture, tests/test_parallel.py:70-72).
JAX_CPU_SHARDED = _modes(
    line={"R@1": 0.1309, "R@10": 0.8203, "top10_intersection": 0.7207},
    exact={"R@1": 0.9902, "R@10": 0.9902, "top10_intersection": 0.9911},
    big={"R@1": 0.1309, "R@10": 0.8203, "top10_intersection": 0.7205})
N_SHARDS, SHARDED_SLACK = 4, 0.002
# The kernels of each path: a count of 0 on its run fails the smoke.  The
# BIG paths launch no row gather: their line re-rank reads the payload rows
# itself, and their bins come from lookups, not extent rows.
PAIR_KERNELS = ("bitonic_topk", "block_scan", "rerank_fused",
                "segmented_reduce", "gather_rows")
PARTS_KERNELS = PAIR_KERNELS + ("lut_gather",)
ALL_KERNELS = PARTS_KERNELS
BIG_KERNELS = tuple(k for k in ALL_KERNELS if k != "gather_rows")
# the exact re-rank's distances, kernels H and D fused: every path that
# serves exact, refine or BIG perfect must launch it
EXACT_KERNELS = ("gather_sqdist",)
# the split path maps its members' ids through lookups (kernel E); the
# multi-DB path reads its bins' starts by lookup, so it gathers no row;
# the command-line query serves the pair path's exact mode
SPLIT_KERNELS = ALL_KERNELS + EXACT_KERNELS
# a shard's exact core reads no line codes (kernel C): extent and payload
# rows by H, distances by the fused kernel
SHARDED_EXACT_KERNELS = ("bitonic_topk", "block_scan", "segmented_reduce",
                         "gather_rows") + EXACT_KERNELS
MULTIDB_KERNELS = BIG_KERNELS + EXACT_KERNELS
CLI_KERNELS = PAIR_KERNELS + EXACT_KERNELS
# every encode: kernel D's per-part norms, kernel L's line codes and
# kernel P's part codes (with k1_build = c1 it asks for no top-k)
BUILD_KERNELS = ("segmented_reduce", "line_codes", "part_codes")
# where the fused kernel appears in the per-kernel line: a mode of the rows
# of the two TPU kernels it replaces on the exact re-rank
SQDIST_ROWS = ("segmented_reduce", "gather_rows")

# Every path's launch counts and recall on an H100 (NVIDIA H100 80GB HBM3,
# 700 W) before kernels H and D were redesigned: a kernel redesign changes
# neither, so a path that differs from them fails the run.  Launches in the
# order of LAUNCH_KEYS (read_launches' names).  gather_rows' counts are
# lower by rerank_fused's than that run's: every line re-rank now reads its
# payload rows itself (`gather_rerank`, kernel C by position) where kernel
# H gathered them first, so H keeps the extent rows, the exact re-rank's ids
# and the parts pipeline's candidate ids only (pair 72 -> 36, parts 36 ->
# 18, slabs 27 -> 18, BIG 9 -> 0, wide 18 -> 9, SIFT1B 330 -> 165).  The
# last column, kernel L's line codes (one launch an encode chunk), is from
# its first passing run on an H100 (NVIDIA H100 80GB HBM3, 700 W): the
# builds only (the pair path's counts include its build), 0 on every
# serving path.  The last, kernel P's part codes, likewise: one launch an
# encode chunk beside L's, where the level-2 tables and their argmin ran
# as PyTorch ops (kernel D's norms stay: P reads them).
LAUNCH_KEYS = ("bitonic_topk", "block_scan", "rerank_fused",
               "segmented_reduce", "lut_gather", "gather_rows",
               "gather_sqdist", "bitonic_topk:sort", "bitonic_topk:select",
               "bitonic_topk:merge", "rerank_fused:wide", "line_codes",
               "part_codes")
REFERENCE_LAUNCHES = {
    "pair": (108, 73, 36, 140, 0, 36, 18, 45, 63, 0, 0, 16, 16),
    "parts": (108, 108, 18, 90, 108, 18, 18, 81, 27, 0, 0, 0, 0),
    "parts_slabs": (72, 81, 9, 63, 81, 18, 9, 54, 18, 0, 0, 0, 0),
    "big_line": (45, 18, 9, 27, 18, 0, 0, 18, 27, 0, 0, 0, 0),
    "big_perfect": (54, 18, 9, 27, 18, 0, 9, 27, 27, 0, 0, 0, 0),
    "pair_wide": (27, 18, 9, 27, 0, 9, 0, 9, 18, 0, 9, 0, 0),
    "sift1b_build": (0, 0, 0, 310, 0, 0, 0, 0, 0, 0, 0, 155, 155),
    "sift1b": (891, 396, 165, 561, 264, 165, 99, 396, 429, 66, 0, 0, 0),
    # phase 7's paths, from their first passing run on an H100 (NVIDIA
    # H100 80GB HBM3, 700 W): split serving, multi-DB serving in memory
    # and spilled, and the command-line query (its warm-up batch and four)
    "split": (207, 108, 54, 162, 54, 54, 36, 99, 108, 0, 0, 0, 0),
    "multidb": (90, 135, 54, 81, 162, 0, 9, 63, 27, 0, 0, 0, 0),
    "multidb_spill": (90, 135, 54, 81, 162, 0, 9, 63, 27, 0, 0, 0, 0),
    "cli": (20, 10, 5, 15, 5, 5, 5, 10, 10, 0, 0, 0, 0),
    # phase 8's paths, from their first passing run on an H100 (NVIDIA
    # H100 80GB HBM3, 700 W)
    "cli_sharded": (25, 10, 0, 10, 5, 10, 5, 15, 10, 0, 0, 0, 0),
    "sharded_line": (117, 72, 36, 108, 0, 36, 0, 45, 72, 0, 0, 0, 0),
    "sharded_exact": (117, 72, 0, 72, 0, 72, 36, 45, 72, 0, 0, 0, 0),
    "sharded_big": (189, 72, 36, 108, 72, 0, 0, 81, 108, 0, 0, 0, 0),
    "sharded_exact_split": (234, 144, 0, 144, 0, 144, 72, 90, 144, 0, 0, 0, 0),
    "sharded_nccl": (117, 72, 0, 72, 0, 72, 36, 45, 72, 0, 0, 0, 0),
    "dp_encode": (0, 0, 0, 32, 0, 0, 0, 0, 0, 0, 0, 16, 16),
    "sift1b_sharded": (1122, 528, 132, 660, 264, 396, 132, 594, 528, 0, 0, 0,
                       0),
}
_EXACT_1M = {"R@1": 0.9931640625, "R@10": 0.9931640625,
             "top10_intersection": 0.99345703125}
_REFINE_1M = dict(_EXACT_1M, top10_intersection=0.993359375)
_LINE_1M = {"R@1": 0.1591796875, "R@10": 0.8115234375}


REFERENCE_RECALL = {
    "pair": _modes(exact=_EXACT_1M, refine=_REFINE_1M, line=dict(
        _LINE_1M, top10_intersection=0.726953125)),
    "parts": _modes(exact=_EXACT_1M, refine=_REFINE_1M, line=dict(
        _LINE_1M, top10_intersection=0.72705078125)),
    "parts_slabs": _modes(exact=_EXACT_1M, line={
        "R@1": 0.16015625, "R@10": 0.810546875,
        "top10_intersection": 0.72724609375}),
    "big_line": _modes(big_line=dict(
        _LINE_1M, top10_intersection=0.72685546875)),
    "big_perfect": _modes(big_perfect=dict(
        _EXACT_1M, top10_intersection=0.99326171875)),
    "pair_wide": _modes(line={"R@1": 0.15625, "R@10": 0.80859375,
                              "top10_intersection": 0.72685546875}),
    "sift1b": _modes(
        exact={"R@1": 0.9990234375, "R@10": 1.0,
               "top10_intersection": 0.99990234375},
        refine={"R@1": 1.0, "R@10": 1.0, "top10_intersection": 1.0},
        big_perfect={"R@1": 1.0, "R@10": 1.0, "top10_intersection": 1.0},
        **{m: {"R@1": 0.16015625, "R@10": 0.7724609375,
               "top10_intersection": 0.6328125}
           for m in ("line", "big_line")}),
}
for _label in ("pair", "parts", "parts_slabs"):
    REFERENCE_RECALL[_label]["candidate_recall"] = 0.9931640625
REFERENCE_RECALL["sift1b"]["candidate_recall"] = 1.0
_SPLIT_EXACT = {"R@1": 0.9912109375, "R@10": 0.9912109375,
                "top10_intersection": 0.99306640625}
REFERENCE_RECALL["split"] = _modes(
    line={"R@1": 0.12890625, "R@10": 0.8212890625,
          "top10_intersection": 0.72041015625},
    exact=_SPLIT_EXACT, refine=_SPLIT_EXACT)
REFERENCE_RECALL["multidb"] = REFERENCE_RECALL["multidb_spill"] = _modes(
    occurrence={"R@1": 0.1376953125, "R@10": 0.529296875,
                "top10_intersection": 0.49267578125},
    distance={"R@1": 0.150390625, "R@10": 0.693359375,
              "top10_intersection": 0.62880859375},
    exact={"R@1": 0.7666015625, "R@10": 0.7666015625,
           "top10_intersection": 0.748046875})
REFERENCE_RECALL["cli"] = _modes(exact={
    "R@1": 0.986328125, "R@10": 0.986328125, "R@100": 0.986328125,
    "top10_intersection": 0.9880859375,
    "top100_intersection": 0.980751953125})
# one shard serves what the unsharded query does: the same recall; at
# SIFT1M the 4 shards' recall equals the one device's in every mode but
# big's top-10 intersection
REFERENCE_RECALL["cli_sharded"] = REFERENCE_RECALL["cli"]
REFERENCE_RECALL["sharded_line"] = _modes(line=dict(
    _LINE_1M, top10_intersection=0.726953125))
REFERENCE_RECALL["sharded_big"] = _modes(big=dict(
    _LINE_1M, top10_intersection=0.7267578125))
for _label in ("sharded_exact", "sharded_exact_split", "sharded_nccl"):
    REFERENCE_RECALL[_label] = _modes(exact=_EXACT_1M)
REFERENCE_RECALL["sift1b_sharded"] = _modes(
    exact={"R@1": 0.9990234375, "R@10": 1.0, "top10_intersection": 1.0},
    line={"R@1": 0.16015625, "R@10": 0.7724609375,
          "top10_intersection": 0.6328125})

N_DB, N_TRAIN, N_QUERIES, BATCH, K = 1_000_000, 200_000, 1024, 256, 100
# The SIFT1B phase: 10M vectors (a cut of SIFT1B's 10^9 forced by the
# smoke's run time) in chunk files of 2M, a tree trained on 200k, 1024
# queries in batches of 64, and its recall floors.
N_1B, N_1B_TRAIN, N_1B_CHUNK, BATCH_1B = 10_000_000, 200_000, 2_000_000, 64
# the host rows of the SIFT1B-width upload checks: 123 chunks, the last
# one short
N_OVERLAP = 8_000_000
SIFT1B_FLOORS = {"exact_R@1": 0.95, "refine_R@1": 0.95,
                 "candidate_recall": 0.95, "line_top10_intersection": 0.5,
                 "big_perfect_R@1": 0.95}


class SmokeFailure(RuntimeError):
    pass


def make_sift_like(n, dim, rng, n_coarse=1024, subs_per_coarse=64,
                   sigma_coarse=15.0, sigma_point=5.0):
    """bench.py's fixture: clustered uint8 vectors, coarse clusters of tight
    subclusters (a copy, so this script needs nothing of the JAX package)."""
    centers = rng.uniform(0, 140, (n_coarse, dim)).astype(np.float32)
    subcenters = (np.repeat(centers, subs_per_coarse, axis=0) +
                  rng.normal(0, sigma_coarse,
                             (n_coarse * subs_per_coarse, dim))
                  ).astype(np.float32)
    out = np.empty((n, dim), np.uint8)
    chunk = 1 << 20
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        which = rng.integers(0, subcenters.shape[0], e - s)
        block = subcenters[which] + rng.normal(0, sigma_point, (e - s, dim))
        out[s:e] = np.clip(np.round(block), 0, 255).astype(np.uint8)
    return out, subcenters


def make_queries(n_queries, subcenters, rng, sigma_point=5.0):
    """bench.py's held-out queries: fresh draws from the cluster model."""
    dim = subcenters.shape[1]
    which = rng.integers(0, subcenters.shape[0], n_queries)
    block = subcenters[which] + rng.normal(0, sigma_point, (n_queries, dim))
    return np.clip(np.round(block), 0, 255).astype(np.float32)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# timings taken with CUDA events because no profiler session recorded any
# device time (each one an upper bound: it includes the gaps between launches)
EVENT_TIMED = []


def _profiled_us(torch, fn, reps):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def device_ms(torch, fn, reps=20, warmup=3, attempts=4):
    """Mean milliseconds the card spends in the kernels fn() launches, from
    the profiler's device events: a run of launches timed with CUDA events
    would measure the host's launch rate for kernels this short.  Now and
    then a profiler session records no device events at all; a throwaway
    session then runs and the session is repeated, up to `attempts` times.
    If none recorded any, the launches are timed with CUDA events instead
    and the timing is counted in EVENT_TIMED."""
    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        us = _profiled_us(torch, fn, reps)
        if us > 0:
            return us / 1e3 / reps
        _profiled_us(torch, lambda: torch.ones(8, device="cuda") + 1, 1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    EVENT_TIMED.append(ms)
    return ms


def rotating_ms(torch, fn, inputs):
    """device_ms of fn over the inputs in turn."""
    turn = iter(range(1 << 30))
    return device_ms(torch, lambda: fn(inputs[next(turn) % len(inputs)]))


def cold_ms(torch, fn, x):
    """device_ms of fn over a rotating set of copies of x that together span
    COLD_SET_BYTES, so every call reads its input from HBM and not from L2
    (device_ms alone repeats fn on one input, which stays in L2)."""
    copies = [x.clone() for _ in range(-(-COLD_SET_BYTES // (
        x.numel() * x.element_size())))]
    ms = rotating_ms(torch, fn, copies)
    del copies
    return ms


def bound(bytes_moved, ops):
    """(least ms, what bounds it) at the card's published peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def topk_cases(torch, gen):
    """The query paths' top-k shapes at batch 256 (p=4, c1=16, W=8, L=128,
    pair_top_m=128, K=1024, k=100, refine k*8=800), phase 7's (the split's
    union of two k-lists, the multi-DB occurrence ranking's full sort of
    the 2 x 512 candidates and its pass over the integer key), then
    SIFT1B_CONFIG's widths (k1_query 16 x c2 16: a 65536-wide pair grid,
    pair_top_m 256, 8192 final candidates), and phase 8's merges of the
    shards' top-100 lists.  Values are rounded to few
    levels in half the rows, and some slots are +inf, so ties occur.  The
    occurrence key is what the ranking sorts: -occurrences (1 or 2 over
    two groups), or 1 where the distance is +inf; nearly every slot ties."""
    shapes = [("l1_select", 256 * 4, 16, 8),
              ("pair_select", 256 * 2, 128 * 128, 128),
              ("part_sort", 256 * 4, 128, 128),
              ("final_topk", 256, 1024, 100),
              ("refine_line_topk", 256, 1024, 800),
              ("refine_exact_topk", 256, 800, 100),
              ("split_union_merge", 256, 2 * 100, 100),
              ("multidb_occurrence_sort", 256, 1024, 1024),
              ("multidb_occurrence_key", 256, 1024, 100),
              ("sift1b_pair_select", 256 * 2, 256 * 256, 256),
              # the same select at the SIFT1B phase's batch of 64: the pair
              # stage and the BIG path's stage 1
              ("sift1b_big_pair_merge", 64 * 2, 256 * 256, 256),
              # the BIG path's stage 2 at SIFT1M widths (n_intermediate 256,
              # 4 x 512 bins enumerated), batch 256
              ("big_final_bins", 256, 256 * 256, 4 * 512),
              ("sift1b_final_topk", 256, 8192, 100),
              ("sift1b_refine_line_topk", 256, 8192, 800),
              # the BIG path's stage 2 at SIFT1B widths (batch 64, and
              # 256), and the whole 65536-wide row: merge mode
              ("sift1b_big_final_bins", 64, 256 * 256, 32768),
              ("sift1b_big_final_bins_all", 64, 256 * 256, 256 * 256),
              ("sift1b_big_final_bins_b256", 256, 256 * 256, 32768),
              # phase 8's merges of the per-shard top-100 lists: 4 shards at
              # batch 256, a slice of the (4, 2) grid's batch, SIFT1B's 4
              # shards at batch 64, and one shard of the sharded CLI
              ("sharded_merge", 256, 4 * 100, 100),
              ("sharded_split_merge", 128, 4 * 100, 100),
              ("sift1b_sharded_merge", 64, 4 * 100, 100),
              ("cli_sharded_merge", 256, 100, 100)]
    for name, b, n, k in shapes:
        x = torch.rand((b, n), generator=gen, device="cuda")
        if name == "multidb_occurrence_key":
            x = torch.where(x < 0.3, 1.0, torch.where(x < 0.5, -2.0, -1.0))
        else:
            x *= 1e4
            x[: b // 2] = torch.round(x[: b // 2] / 1e3)
            x[torch.rand((b, n), generator=gen, device="cuda") < 0.05] = \
                float("inf")
        yield name, (x.contiguous(), k), (b, n, k)


def topk_modes(prim, n, k):
    """Kernel A's modes that take rows of n elements, k kept: a sort of at
    most TOPK_SORT_MAX elements, a select of at most TOPK_SORT_MAX, and,
    for k above that, a merge of at most TOPK_MERGE_MAX."""
    return [mode for mode, size, cap in (
        ("sort", n, prim.TOPK_SORT_MAX), ("select", k, prim.TOPK_SORT_MAX),
        ("merge", k if k > prim.TOPK_SORT_MAX else 0, prim.TOPK_MERGE_MAX))
        if 0 < size <= cap]


def topk_plans(prim, n, k, every=False):
    """(label, plan) of each of kernel A's modes and routes that take rows
    of n elements, k kept: every mode of topk_modes on the one-block route
    and, for rows of more than TOPK_SORT_MAX elements (for any row with
    `every`, which also tries merge mode's cluster route at k <=
    TOPK_SORT_MAX), select and merge on every cluster size that holds
    them."""
    modes = topk_modes(prim, n, k)
    plans = [(mode, prim._topk_plan(n, k, mode, 0)) for mode in modes]
    if n <= prim.TOPK_SORT_MAX and not every:
        return plans
    on_cluster = [m for m in modes if m != "sort"]
    if every and "merge" not in on_cluster:
        on_cluster.append("merge")
    for mode in on_cluster:
        for c in prim.TOPK_CLUSTER_SIZES:
            try:
                plans.append((f"{mode} cluster {c}",
                              prim._topk_plan(n, k, mode, c)))
            except NotImplementedError:
                pass
    return plans


def topk_reads(torch, prim, x, k, plan):
    """(reads, scratch bytes) of kernel A's one-block plan on x, worked out
    from x (a model, not a measurement): how many times it reads each row
    from device memory or L2, and the bytes of scratch rows it writes and
    reads.  The one-block select reads a row longer than one tile again on
    every pass (so does the one-block merge's select, for k < n); the
    one-block merge then reads and writes its scratch rows of sort_len
    pairs in the run sorts and in each merge pass (the last one writes k
    pairs).  (None, 0) for the cluster route: its source reads the row
    once, but what its registers spill to local memory is not counted."""
    b, n = x.shape
    if plan.cluster:
        return None, 0
    reads = 1.0
    if plan.mode in ("select", "merge") and k < n and \
            n > plan.items * plan.threads:
        reads += float(radix_passes(torch, x, k, prim.TOPK_DIGIT_BITS)
                       .double().mean())
    scratch = 0
    if plan.mode == "merge":
        passes = (plan.sort_len // prim.TOPK_SORT_MAX).bit_length() - 1
        scratch = b * plan.sort_len * 8 * (2 * passes + 2 * int(k < n))
    return reads, scratch


def scan_plans(prim, rows, n):
    """Kernel B's plans, one a mode, for every mode that takes (rows, n)."""
    plans = []
    for mode in ("rows", "onepass"):
        try:
            plans.append(prim._scan_plan(rows, n, mode))
        except NotImplementedError:
            pass
    return plans


def scan_replays(torch, prim, x, excl, plans, gen, replays=4):
    """Onepass mode under CUDA graph replay: the launch captured on a
    static input (with its zeroing node, `_scan_status`), replayed on new
    inputs drawn in turn, each result held against the plain version; the
    replay's device time beside the eager launch's.  Returns {} for a
    shape no onepass plan takes."""
    plan = next((p for p in plans if p.mode == "onepass"), None)
    if plan is None:
        return {}
    static = x.clone()
    prim._scan_launch(static, excl, plan)            # built and warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prim._scan_launch(static, excl, plan)
    for _ in range(replays):
        static.copy_(torch.randint(0, 3, static.shape, generator=gen,
                                   device="cuda", dtype=torch.int32))
        graph.replay()
        if not torch.equal(out, prim.block_scan_plain(static, excl)):
            raise SmokeFailure(f"block_scan {tuple(x.shape)} onepass: a "
                               "replay differs from the plain version")
    ms = device_ms(torch, graph.replay)
    eager_ms = device_ms(torch, lambda: prim._scan_launch(x, excl, plan))
    del graph, out, static
    return {"onepass_replay_ms": ms, "onepass_eager_ms": eager_ms}


def radix_passes(torch, x, k, digit_bits):
    """Histogram passes kernel A's select mode makes over each row of x, as
    csrc/topk.cu makes them: digits of the order-preserving key, most
    significant first, stopping once the k-th key's bucket is taken whole."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    b, bins = x.shape[0], 1 << digit_bits
    prefix = torch.zeros(b, dtype=torch.int64, device=x.device)
    need = torch.full((b,), k, dtype=torch.int64, device=x.device)
    done = torch.zeros(b, dtype=torch.bool, device=x.device)
    passes = torch.zeros(b, dtype=torch.int64, device=x.device)
    for shift in range(32, 0, -digit_bits):
        lo = shift - digit_bits
        live = (key >> shift) == (prefix >> shift)[:, None]
        d = torch.where(live, (key >> lo) & (bins - 1), bins)
        hist = torch.zeros((b, bins + 1), dtype=torch.int64,
                           device=x.device).scatter_add_(
            1, d, torch.ones_like(d))[:, :bins]
        incl = hist.cumsum(1)
        # rows already done may find no bucket: their result is not read
        bucket = (incl < need[:, None]).sum(1, keepdim=True).clamp_max(
            bins - 1)
        count = hist.gather(1, bucket)[:, 0]
        before = incl.gather(1, bucket)[:, 0] - count
        go = ~done
        passes += go
        prefix = torch.where(go, prefix | (bucket[:, 0] << lo), prefix)
        need = torch.where(go, need - before, need)
        done |= go & (need == count)
    return passes


def scan_cases(torch, gen):
    """The prefix sums of the paths at batch 256 (512 probed bins, 2048
    enumerated and 768 surviving slots, the 2^20-slot CSR prefix, the
    multi-DB engine's per-group and dedup scans), then SIFT1B_CONFIG's
    (8192 probed bins, 32768 enumerated slots, 2^29 slots).
    Tensors are made in the yield, so none outlives its case here."""
    b = 256

    def capped(n):      # per-bin candidate counts, capped at 1024
        return torch.randint(0, 1025, (b, n), generator=gen, device="cuda",
                             dtype=torch.int32)

    def flags(n):       # 0/1 keep flags of a compaction
        return torch.randint(0, 2, (b, n), generator=gen, device="cuda",
                             dtype=torch.int32)

    yield "candidate_prefix", (capped(512), False), (b, 512)
    yield "probe_compaction", (flags(512), True), (b, 512)
    yield "filter_compaction", (flags(2048), True), (b, 2048)
    yield "survivor_compaction", (flags(768), True), (b, 768)
    # a multi-DB group's 256 enumerated bins (512 / 2 groups), and the run
    # starts of the 1024 candidates' sorted ids (_duplicate_stats)
    yield "multidb_group_candidate_prefix", (capped(256), False), (b, 256)
    yield "multidb_group_compaction", (flags(256), True), (b, 256)
    yield "multidb_duplicate_runs", (flags(1024), False), (b, 1024)
    yield "csr_prefix", (torch.poisson(
        torch.ones(1 << 20, device="cuda"), generator=gen).to(
            torch.int32)[None, :].contiguous(), False), (1, 1 << 20)
    yield "sift1b_candidate_prefix", (capped(8192), False), (b, 8192)
    yield "sift1b_compaction", (flags(32768), True), (b, 32768)
    # the BIG stage-2 compaction at the SIFT1B phase's batch of 64: fewer
    # than SCAN_MANY_ROWS rows, so onepass mode
    yield "sift1b_big_compaction_b64", (torch.randint(
        0, 2, (64, 32768), generator=gen, device="cuda",
        dtype=torch.int32), True), (64, 32768)
    # bin occupancy counts of mean 1 over 2^29 slots (2 GiB)
    yield "sift1b_csr_prefix", (torch.randint(
        0, 3, (1, 1 << 29), generator=gen, device="cuda",
        dtype=torch.int32), False), (1, 1 << 29)


def line_payload(torch, gen, n, lp, c1, compact):
    """n payload rows of random line codes as the build packs them (id =
    row, t3 ~ N(0, 1), lambda in [-0.5, 1.5): a projection inside or near
    its segment), made on the card a million rows at a time: (n, W) int32,
    W = 2 + ceil(lp / 2) compact (A | B << 4 | lambda_u8 << 8, two line
    parts a word) or 2 + lp wide (A | B << 8 | lambda_u16 << 16)."""
    w = 2 + ((lp + 1) // 2 if compact else lp)
    out = torch.empty((n, w), dtype=torch.int32, device="cuda")
    for s in range(0, n, 1 << 20):
        m = min(1 << 20, n - s)
        a, bb = (torch.randint(0, c1, (m, lp), generator=gen, device="cuda")
                 for _ in range(2))
        if compact:
            lam = torch.randint(112, 176, (m, lp), generator=gen,
                                device="cuda")
            half = torch.nn.functional.pad(a | (bb << 4) | (lam << 8),
                                           (0, lp % 2))
            words = half[:, 0::2] | (half[:, 1::2] << 16)
        else:
            lam = torch.randint(28672, 45056, (m, lp), generator=gen,
                                device="cuda")
            words = a | (bb << 8) | (lam << 16)
        out[s:s + m, 0] = torch.arange(s, s + m, device="cuda")
        out[s:s + m, 1] = torch.randn(m, generator=gen,
                                      device="cuda").view(torch.int32)
        out[s:s + m, 2:] = torch.where(words >= 2 ** 31, words - 2 ** 32,
                                       words)
    return out


# The line re-rank's shapes: (name, payload rows, queries, candidates, lp,
# c1, compact, slab): SIFT1M's (batch 256, 1024 candidates, lp 16) in rows
# and slab mode (32 rows a slab) and over the wide payload, SIFT1B's (batch
# 64, 8192 candidates, lp 32) compact and wide at c1 16 and 256, then
# tables past what the kernel took before: 64 KB (lp 64, c1 256), and 240
# KB (lp 240, c1 256, beyond a block's 227 KB; its 968-byte rows unstaged).
# A multi-DB group's re-rank takes 512 of the 1024 candidates (phase 7);
# the split members' take sift1m_line's shape over their dense and sparse
# rows (the plan does not depend on the payload's row count).
RERANK_SHAPES = (
    ("sift1m_line", 1_000_000, 256, 1024, 16, 16, True, 0),
    ("sift1m_line_slabs", 1_000_000, 256, 1024, 16, 16, True, 32),
    ("multidb_group_line", 1_000_000, 256, 512, 16, 16, True, 0),
    ("sift1m_wide_line", 1_000_000, 256, 1024, 16, 16, False, 0),
    ("sift1b_line", N_1B, 64, 8192, 32, 16, True, 0),
    ("sift1b_wide_line", N_1B, 64, 8192, 32, 16, False, 0),
    ("sift1b_wide_line_c1_256", N_1B, 64, 8192, 32, 256, False, 0),
    ("wide_lp64_c1_256", 1_000_000, 64, 8192, 64, 256, False, 0),
    ("wide_lp240_c1_256", 100_000, 8, 8192, 240, 256, False, 0))


def rerank_cases(torch, gen, names=None):
    """The line re-rank at RERANK_SHAPES (or those in `names`): (name,
    (payload, draw, valid, q, compact), (b, k, lp, c1, slab)).  draw()
    makes a new (b, k) set of positions: uniform over the payload with the
    invalid slots at row 0 (rows mode, as the paths' safe positions), or
    windows of `slab` consecutive rows from uniform starts; about 10% of the
    slots are invalid.  Tables are uniform in [0, 5000)."""
    for name, n, b, k, lp, c1, compact, slab in RERANK_SHAPES:
        if names and name not in names:
            continue
        payload = line_payload(torch, gen, n, lp, c1, compact)
        valid = torch.rand((b, k), generator=gen, device="cuda") >= 0.1

        def draw(n=n, b=b, k=k, slab=slab, valid=valid):
            if slab:
                starts = torch.randint(0, n - slab + 1, (b, k // slab, 1),
                                       generator=gen, device="cuda")
                return (starts + torch.arange(slab, device="cuda")).reshape(
                    b, k).to(torch.int32)
            pos = torch.randint(0, n, (b, k), generator=gen, device="cuda",
                                dtype=torch.int32)
            return torch.where(valid, pos, 0)

        q = torch.rand((b, lp, c1), generator=gen, device="cuda") * 5e3
        yield name, (payload, draw, valid, q, compact), (b, k, lp, c1, slab)
        del payload
        torch.cuda.empty_cache()


def old_line_route(ga, rr, payload, pos, valid, q, compact):
    """The line re-rank by the route `gather_rerank` replaced: kernel H's
    payload rows, kernel C over them, +inf where invalid."""
    rows = ga.gather_rows(payload, pos)
    return rows[..., 0], rr.rerank_fused(rows, q, compact).where(
        valid, float("inf"))


def check_line_rerank(torch, ga, rr, payload, pos, valid, q, compact):
    """Holds gather_rerank against its plain version (ids equal, distances
    within rtol 1e-5, atol 1e-4, +inf exactly where invalid or outside
    the payload) and against kernel C over the same rows gathered first
    (equal to the bit: one kernel, one per-row arithmetic).  Returns the
    largest distance error against the plain version."""
    ids, dists = rr.gather_rerank(payload, pos, valid, q, compact)
    want_ids, want = rr.gather_rerank_plain(payload, pos, valid, q, compact)
    n = payload.shape[0]
    inside = (pos >= 0) & (pos < n)
    rows = payload[pos.long().clamp(0, n - 1)]
    old = torch.where(valid & inside, rr.rerank_fused(rows, q, compact),
                      float("inf"))
    torch.cuda.synchronize()
    live = torch.isfinite(want)
    err = float((dists[live] - want[live]).abs().max()) if live.any() else 0.0
    ok = (torch.equal(ids, want_ids) and torch.equal(torch.isfinite(dists),
                                                     live)
          and torch.allclose(dists[live], want[live], rtol=1e-5, atol=1e-4)
          and torch.equal(dists, old))
    return ok, err


def reduce_cases(torch, gen):
    """Integer values of uint8 range, signed, as the distance tables' per-part
    norms see them: a query batch of 256 (p = 4, line_parts = 16), then
    SIFT1B_CONFIG's encode, 65536 vectors a step (p = 4, line_parts = 32).
    Each is summed in square mode (the tables' norms) and, squared
    beforehand, in plain mode.  The exact re-rank's row sums are
    `gather_sqdist`'s."""
    for name, rows, d, parts in (("part_norms", 256, 128, 4),
                                 ("line_part_norms", 256, 128, 16),
                                 ("sift1b_encode_part_norms", 65536, 128, 4),
                                 ("sift1b_encode_line_part_norms", 65536, 128,
                                  32)):
        v = torch.randint(-255, 256, (rows, d), generator=gen,
                          device="cuda").to(torch.float32)
        yield name, (v, parts), (rows, d, parts)


def lut_cases(torch, gen):
    """The lookups of the parts path at batch 256 (p = 4, base 16, 2048
    enumerated bins, 768 filter survivors, 512 probed bins): the uint8 pair
    table, first one pair's 65536 cells at (256, 256) as earlier runs timed
    it, then as the pair filter calls it, both pairs' 128 KB at (256, 2 x
    256); the 2^20-slot occupancy counts and CSR starts; phase 7's: a
    multi-DB group's counts and CSR starts at its 256 enumerated bins (its
    pair_occ lookups are `pair_occ`'s shape), and the split's
    local-to-global id maps (0.3M and 0.7M ids, the dense share of percent
    0.3) at the k = 100 results; then SIFT1B_CONFIG's 2^29-slot (2 GiB)
    counts at 32768 enumerated bins and CSR starts at 8192 probed bins."""
    pair_occ = (torch.rand(2 << 16, generator=gen, device="cuda") < 0.3
                ).to(torch.uint8)
    counts = torch.poisson(torch.ones(1 << 20, device="cuda"),
                           generator=gen).to(torch.int32)
    prefix = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    ids = torch.randperm(1_000_000, generator=gen, device="cuda").to(
        torch.int32)
    for name, table, e in (("pair_occ", pair_occ[:1 << 16], 256),
                           ("pair_occ_both_pairs", pair_occ, 2 * 256),
                           ("counts_unfiltered", counts, 2048),
                           ("counts_filtered", counts, 768),
                           ("prefix", prefix, 512),
                           ("multidb_group_counts", counts, 256),
                           ("multidb_group_prefix", prefix, 256),
                           ("split_dense_ids", ids[:300_000], 100),
                           ("split_sparse_ids", ids[300_000:], 100)):
        idx = torch.randint(0, table.shape[0], (256, e), generator=gen,
                            device="cuda", dtype=torch.int32)
        yield name, (table.contiguous(), idx), (256, e)
    del pair_occ, counts, prefix, ids
    big = torch.randint(0, 3, (1 << 29,), generator=gen, device="cuda",
                        dtype=torch.int32)
    for name, e in (("sift1b_counts", 32768), ("sift1b_prefix", 8192)):
        yield name, (big, torch.randint(0, 1 << 29, (256, e), generator=gen,
                                        device="cuda", dtype=torch.int32)), \
            (256, e)


def gather_cases(torch, gen):
    """The row gathers of both paths at batch 256: compact payload rows (1M
    x 10 int32) for 1024 candidates, in rows mode and as 32 slabs of 32
    rows; uint8 vectors (1M x 128) for 1024 exact and 800 refine
    candidates (the old exact route's first launch); the (start,
    end) extent rows of 512 probed bins.  Then SIFT1B_CONFIG's widths at
    batch 64: the extent rows of 32768 enumerated bins from the 2^29-slot
    probe table (4 GiB), and 8192 candidates' compact payload rows (lp 32:
    72 bytes) and vectors_csr rows (128 bytes) from 10M rows.  Positions
    are uniform over the table."""
    n = 1_000_000
    payload = torch.randint(-(1 << 30), 1 << 30, (n, 10), generator=gen,
                            device="cuda", dtype=torch.int32)
    vectors = torch.randint(0, 256, (n, 128), generator=gen, device="cuda",
                            dtype=torch.uint8)
    prefix2 = torch.randint(0, n, (1 << 20, 2), generator=gen, device="cuda",
                            dtype=torch.int32)

    def positions(tab, b, k, span):
        return torch.randint(0, tab.shape[0] - span + 1, (b, k),
                             generator=gen, device="cuda", dtype=torch.int32)

    for name, tab, k, span in (("payload_rows", payload, 1024, 1),
                               ("payload_slabs", payload, 32, 32),
                               ("vectors_exact", vectors, 1024, 1),
                               ("vectors_refine", vectors, 800, 1),
                               ("extent_rows", prefix2, 512, 1)):
        yield name, (tab, positions(tab, 256, k, span), span)
    del payload, vectors, prefix2
    for name, make, k in (
            ("sift1b_extent_rows", lambda: torch.randint(
                0, N_1B, (1 << 29, 2), generator=gen, device="cuda",
                dtype=torch.int32), 32768),
            ("sift1b_payload_rows", lambda: torch.randint(
                -(1 << 30), 1 << 30, (N_1B, 18), generator=gen,
                device="cuda", dtype=torch.int32), 8192),
            ("sift1b_vectors_csr", lambda: torch.randint(
                0, 256, (N_1B, 128), generator=gen, device="cuda",
                dtype=torch.uint8), 8192)):
        tab = make()
        yield name, (tab, positions(tab, 64, k, 1), 1)
        del tab
        torch.cuda.empty_cache()


def sqdist_cases(torch, gen):
    """The exact re-rank's distances (`gather_sqdist`) at the shapes the
    paths give it, with integer-valued queries: SIFT1M exact (256, 1024)
    and refine (256, 800) rows of a 1M x 128 uint8 table, the exact shape
    again over a 1M x 128 float32 table, then SIFT1B exact (64, 8192) and
    refine and BIG perfect (64, 800) rows of a 10M x 128 uint8 table (1.28
    GB).  Positions are uniform over the table."""
    def case(tab, b, k):
        return (tab, torch.randint(0, tab.shape[0], (b, k), generator=gen,
                                   device="cuda", dtype=torch.int32),
                torch.randint(0, 256, (b, tab.shape[1]), generator=gen,
                              device="cuda").to(torch.float32))

    vectors = torch.randint(0, 256, (1_000_000, 128), generator=gen,
                            device="cuda", dtype=torch.uint8)
    yield "sift1m_exact", case(vectors, 256, 1024)
    yield "sift1m_refine", case(vectors, 256, 800)
    yield "sift1m_exact_float32", case(vectors.to(torch.float32), 256, 1024)
    vectors = torch.randint(0, 256, (N_1B, 128), generator=gen,
                            device="cuda", dtype=torch.uint8)
    yield "sift1b_exact", case(vectors, 64, 8192)
    yield "sift1b_refine_big_perfect", case(vectors, 64, 800)
    del vectors
    torch.cuda.empty_cache()


def old_exact_route(ga, prim, tab, pos, q):
    """The exact re-rank's distances by the route `gather_sqdist` replaced:
    kernel H's row gather, the float copy, the difference, the square and
    kernel D's row sums (five launches)."""
    b, k = pos.shape
    diff = ga.gather_rows(tab, pos).to(q.dtype) - q[:, None, :]
    return prim.segmented_reduce((diff * diff).reshape(b * k, -1),
                                 1).reshape(b, k)


def sectors_touched(torch, pos, row_bytes):
    """The distinct 32-byte sectors the rows at `pos` lie in: a random read
    moves every sector it touches whole."""
    start = pos.to(torch.int64).reshape(-1) * row_bytes
    first, last = start // 32, (start + row_bytes - 1) // 32
    spans = [first + j for j in range(int((last - first).max()) + 1)]
    return int(torch.unique(torch.cat([s[s <= last] for s in spans])).numel())


# Kernel L's shapes: a 65536-row encode chunk (ENCODE_CHUNK) at SIFT1M's
# and SIFT1B's line parts (lp 16 and 32, c1 16), each at both lambda widths
LINE_CODE_SHAPES = (("sift1m_chunk", 16, 16), ("sift1b_chunk", 32, 16))


def line_terms_case(torch, gen, n, lp, c1, dim=128, noise=8.0):
    """A chunk's line tables' terms as the encode makes them: (dot, xn, cn)
    of integer-valued rows in [0, 255] and c1 random centroids
    (ops/distance.py subpart_sqdist_terms: dot in the layout the line GEMM
    writes), and the (lp, c1, c1) pair table.  Each row lies about a point
    of the line between two centroids (lambda in [-0.2, 1.2)), so every
    line part has a real choice to make."""
    from pqt_tpu_torch.ops import distance as D
    cent = torch.rand((c1, dim), generator=gen, device="cuda") * 140
    i, j = (torch.randint(0, c1, (n,), generator=gen, device="cuda")
            for _ in range(2))
    t = torch.rand((n, 1), generator=gen, device="cuda") * 1.4 - 0.2
    x = ((1 - t) * cent[i] + t * cent[j]
         + noise * torch.randn((n, dim), generator=gen, device="cuda"))
    x = torch.clamp(torch.round(x), 0, 255)
    return (*D.subpart_sqdist_terms(x, cent, lp),
            D.centroid_pair_sqdist(cent, lp))


def tables_as_terms(torch, d):
    """Terms (dot, xn, cn) whose distances clamp_min(xn + cn - 2 dot, 0)
    are the tables d (n, lp, c1) wherever d is not below 0: dot = -d / 2,
    exact for normal numbers, infinities and NaN, and zero norms."""
    n, lp, c1 = d.shape
    return (d * -0.5, torch.zeros((n, lp), device=d.device),
            torch.zeros((c1, lp), device=d.device))


def line_code_hard_cases(torch, gen):
    """Line-code selections that are easiest to get wrong: (name, dot, xn,
    cn, pair_dists).  Tables fed as terms that reproduce them
    (tables_as_terms): coincident centroids (pair distances 0: lambda from
    a divide by 1e-20, residuals of -inf and NaN), a line part whose
    centroids all coincide, small integer distances (exact residual ties),
    lambda far past both ends of [-4, 4), lambda on a fine grid about -4
    and 4 (one pair, c1 2), NaN, infinite and -inf (clamped) distances, all
    zeros.  Then the GEMM's own terms: rows equal to a centroid (segment
    distances that round below 0 and clamp) and rows holding inf, -inf and
    NaN at SIFT1B's and GIST's widths; ragged row counts on the c1 16
    route; the loop route at c1 2, 5, 17, 64 and 256; the GEMM's output
    copied contiguous (c1 values still contiguous), with the line parts
    innermost and 4 bytes off a 16-byte boundary (the loop route); and no
    rows at all."""
    def on_card(d, p):
        d, p = (x.to(device="cuda", dtype=torch.float32).contiguous()
                for x in (d, p))
        return (*tables_as_terms(torch, d), p)

    from pqt_tpu_torch.ops import distance as D
    n, lp, c1, dim = 1000, 4, 16, 32
    cent = torch.randint(0, 20, (c1, dim), generator=gen,
                         device="cuda").float()
    cent[5] = cent[3]
    cent[9] = cent[10] = cent[11] = cent[12]
    x = cent[torch.randint(0, c1, (n,), generator=gen, device="cuda")]
    x[n // 2:] += torch.randint(-2, 3, (n - n // 2, dim), generator=gen,
                                device="cuda")
    yield "coincident centroids", *on_card(
        D.subpart_sqdist_tables(x, cent, lp), D.centroid_pair_sqdist(cent, lp))
    flat = cent.clone()
    flat[:, :dim // lp] = flat[0, :dim // lp]
    yield "a line part of one point", *on_card(
        D.subpart_sqdist_tables(x, flat, lp), D.centroid_pair_sqdist(flat, lp))
    yield "integer ties", *on_card(
        torch.randint(0, 4, (n, lp, c1), generator=gen, device="cuda"),
        torch.randint(0, 4, (lp, c1, c1), generator=gen, device="cuda"))
    yield "lambda far past both ends", *on_card(
        torch.rand((n, lp, c1), generator=gen, device="cuda") * 100,
        torch.rand((lp, c1, c1), generator=gen, device="cuda") * 0.9 + 0.1)
    # lambda = -0.5 * (a2 - b2 - 1) for b2 = 100, c2 = 1
    lam = torch.cat([e + torch.arange(-3000, 3000, dtype=torch.float64,
                                      device="cuda") * 2.0 ** -18
                     for e in (-4.0, 4.0)])
    yield "lambda about -4 and 4 (c1 2)", *on_card(
        torch.stack([torch.full_like(lam, 100.0), 101.0 - 2.0 * lam],
                    1)[:, None, :],
        torch.tensor([[[0.0, 1.0], [1.0, 0.0]]], device="cuda"))
    dot, xn, cn, p = line_terms_case(torch, gen, n, lp, c1, dim)
    d = D.subpart_sqdist_from_terms(dot, xn, cn)
    d[0, 0, 3] = float("nan")
    d[1] = float("nan")
    d[2, 1, :] = float("inf")
    d[3, 2, 7] = float("inf")
    d[4, 3, 0] = float("-inf")
    yield "NaN and infinite distances", *on_card(d, p)
    yield "zeros", *on_card(torch.zeros((n, lp, c1)),
                            torch.zeros((lp, c1, c1)))
    for dim, lp in ((128, 32), (960, 32)):
        cent = torch.rand((16, dim), generator=gen, device="cuda") * 140
        x = torch.round(torch.rand((1000, dim), generator=gen,
                                   device="cuda") * 255)
        x[:200] = cent[torch.randint(0, 16, (200,), generator=gen,
                                     device="cuda")]
        x[200, 5] = float("inf")
        x[201] = float("inf")
        x[202, 3 * dim // lp] = float("nan")
        x[203, 7] = float("-inf")
        yield (f"centroid rows, inf and NaN at dim {dim}",
               *D.subpart_sqdist_terms(x, cent, lp),
               D.centroid_pair_sqdist(cent, lp))
    for rows, parts, width in ((1, 32, 16), (255, 32, 16), (257, 16, 16),
                               (70001, 3, 16), (1000, 1, 16), (300, 4, 2),
                               (300, 4, 5), (300, 4, 17), (200, 2, 64),
                               (40, 2, 256), (0, 32, 16)):
        yield (f"({rows}, {parts}, {width})",
               *line_terms_case(torch, gen, rows, parts, width, 32 * parts))
    dot, xn, cn, p = line_terms_case(torch, gen, 1000, 8, 16)
    yield "dot contiguous", dot.contiguous(), xn, cn, p
    inner = dot.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    yield "line parts innermost", inner, xn, cn, p
    off = torch.empty(dot.numel() + 1, device="cuda")[1:].view(
        dot.shape[1], dot.shape[0], dot.shape[2])
    off.copy_(dot.transpose(0, 1))
    yield "c1 16, 4 bytes off", off.transpose(0, 1), xn, cn, p


def same_line_codes(torch, got, want):
    """Whether two (codes, terms) pairs are equal to the bit."""
    return (got[0].dtype == want[0].dtype == torch.int64
            and torch.equal(got[0], want[0])
            and torch.equal(got[1].view(torch.int32),
                            want[1].view(torch.int32)))


# kernel P at the SIFT presets' part widths (p 4, c1 * c2 256, vl 32: SIFT1M's
# and SIFT1B's chunks alike) and at GIST's vl 240 (its loop route)
PART_CODE_SHAPES = (("sift chunk", 4, 256, 32), ("gist chunk", 4, 256, 240))
# a pick of kernel P that differs from its plain version's must be a
# near-tie: the plain distances of the two picks this close, relatively;
# and at most this share of a chunk's codes may differ
NEAR_TIE_REL, PART_CODES_DIFFER = 1e-6, 1e-4


def part_codes_case(torch, gen, n, p, k, vl, noise=8.0):
    """Rows as the encode sees them: integer values in [0, 255] about one of
    k random centroids in [0, 140) a part; (x (n, p * vl), codebook (p, k,
    vl))."""
    cb = torch.rand((p, k, vl), generator=gen, device="cuda") * 140
    pick = torch.randint(0, k, (n, p), generator=gen, device="cuda")
    x = cb[torch.arange(p, device="cuda")[None, :], pick]
    x = x + noise * torch.randn(x.shape, generator=gen, device="cuda")
    return torch.clamp(torch.round(x), 0, 255).reshape(n, p * vl), cb


def part_code_differences(torch, x, cb):
    """Kernel P against its plain version on x (n, p * vl) and codebook
    (p, k, vl): (codes (n, p), the number of codes that differ, whether
    each is a near-tie, the largest relative gap of the plain distances of
    the two picks)."""
    from pqt_tpu_torch.ops import distance as D
    from pqt_tpu_torch.ops.cuda import partcodes as pc
    args = D.part_norms(x, cb)
    got = pc.part_codes(*args)
    want = D.part_codes_plain(*args)
    torch.cuda.synchronize()
    rows, parts = (got != want).nonzero(as_tuple=True)
    if rows.numel() == 0:
        return got, 0, True, 0.0
    t = D.part_sqdist_tables(x, cb)
    a = t[rows, parts, got[rows, parts]].double()
    b = t[rows, parts, want[rows, parts]].double()
    gap = float(((a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp_min(
        1e-30)).max())
    return got, int(rows.numel()), gap <= NEAR_TIE_REL, gap


def part_code_hard_cases(torch, gen):
    """Part-code selections that are easiest to get wrong: (name, x,
    codebook, exact), exact where every distance is an integer float32
    holds (kernel P then equals its plain version to the bit).  Small
    integers (ties everywhere: the first wins), rows on a centroid with a
    centroid twice, NaN and infinite rows and centroids, all zeros; ragged
    row counts; the loop route at k 1, 16, 100, 300 and 512 and vl 4, 8,
    17, 64 and 240; rows 4 bytes off a 16-byte boundary; no rows."""
    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=gen,
                             device="cuda").float()

    yield "integer ties", ints((1000, 32), 3), ints((4, 256, 8), 3), True
    cb = ints((4, 256, 32), 20)
    cb[:, 9] = cb[:, 3]
    x = cb[torch.arange(4, device="cuda")[None, :],
           torch.randint(0, 256, (1000, 4), generator=gen, device="cuda")]
    yield "rows on centroids", x.reshape(1000, 128), cb, True
    x, cb = ints((300, 128), 20), ints((4, 256, 32), 20)
    x[0, 0] = float("nan")
    x[1] = float("inf")
    x[2, 32:64] = float("-inf")
    cb[2, 5, 0] = float("nan")
    cb[3, 7] = float("inf")
    yield "NaN and infinite values", x, cb, True
    yield "zeros", ints((300, 128), 1), ints((4, 256, 32), 1), True
    for rows, p, k, vl in ((1, 4, 256, 32), (63, 4, 256, 32),
                           (65, 4, 256, 32), (70001, 2, 256, 32),
                           (300, 4, 1, 4), (300, 4, 16, 8), (300, 3, 100, 17),
                           (300, 4, 300, 8), (200, 2, 512, 64),
                           (300, 4, 256, 240), (0, 4, 256, 32)):
        yield (f"({rows}, {p}, {k}, {vl})",
               *part_codes_case(torch, gen, rows, p, k, vl), False)
    x, cb = part_codes_case(torch, gen, 1000, 4, 256, 32)
    off = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    off.copy_(x)
    yield "4 bytes off", off, cb, False


def check_kernels(torch):
    from pqt_tpu_torch.ops import distance as D
    from pqt_tpu_torch.ops import linecodes as L
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import linecodes as lc
    from pqt_tpu_torch.ops.cuda import partcodes as pc
    from pqt_tpu_torch.ops.cuda import primitives as prim
    from pqt_tpu_torch.ops.cuda import rerank as rr

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    # the first profiler session of a process may record no device events
    _profiled_us(torch, lambda: torch.ones(8, device="cuda") + 1, 1)
    # the least device time a launch shows: a shape at it is at the floor
    floor = device_ms(torch, lambda: torch.empty(1, device="cuda").fill_(0))
    print(f"launch floor (device ms of a one-element fill_) {floor:.4f}",
          flush=True)

    def record(name, route_src, replaces, case, ms, plain_ms, lib_ms, b_ms,
               b_by, err, **extra):
        """Add one shape's numbers (and `extra` ones of that shape alone); a
        kernel's totals sum its shapes."""
        if ms <= 0 or plain_ms <= 0 or (lib_ms is not None and lib_ms <= 0):
            raise SmokeFailure(f"{name} {case}: no time recorded")
        r = results.setdefault(name, {
            "name": name, "route": "cuda", "source": route_src,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": b_by,
            "library_ms": None if lib_ms is None else 0.0, "shapes": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        if lib_ms is not None:
            r["library_ms"] += lib_ms
        if b_ms > max((c["bound_ms"] for c in r["shapes"]), default=0.0):
            r["bound_by"] = b_by
        r["bound_ms"] += b_ms
        r["shapes"].append({"case": case, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "max_abs_err": err, **extra})

    for case, (x, k), (b, n, _) in topk_cases(torch, gen):
        # the plan the wrapper picks and every other mode and route that
        # takes the shape: each is held against the plain version to the
        # bit, each is timed
        plan = prim._topk_plan(n, k)
        plans = topk_plans(prim, n, k)
        label = next(lab for lab, p in plans if p == plan)
        pv, pi = prim.bitonic_topk_plain(x, k)
        for lab, p in plans:
            v, i = (prim.bitonic_topk(x, k) if p == plan
                    else prim._topk_launch(x, k, p))
            torch.cuda.synchronize()
            if not (torch.equal(v, pv) and torch.equal(i, pi)):
                bad = int((i != pi).sum())
                raise SmokeFailure(f"bitonic_topk {case} ({lab}): {bad} "
                                   "indices differ from the plain version")
        b_ms, b_by = bound(b * n * 4 + b * k * 8, b * n)
        reads, scratch = topk_reads(torch, prim, x, k, plan)
        # the one-block route's modelled reads, and the bound they give
        modelled = {} if reads is None else {
            "reads": reads, "pass_bound_ms": bound(
                reads * b * n * 4 + b * k * 8 + scratch, b * n)[0]}
        others = [(lab, p) for lab, p in plans if p != plan]
        long_row = n > prim.TOPK_SORT_MAX
        record("bitonic_topk", "pqt_tpu_torch/csrc/topk.cu",
               "pqt_tpu/ops/pallas/primitives.py:79",
               f"{case} ({b},{n})->{k} {label}",
               device_ms(torch, lambda: prim.bitonic_topk(x, k)),
               device_ms(torch, lambda: prim.bitonic_topk_plain(x, k)),
               device_ms(torch, lambda: torch.topk(x, k, largest=False)),
               b_ms, b_by, 0.0, mode=plan.mode, route=label, **modelled,
               other_routes={lab: device_ms(
                   torch, lambda: prim._topk_launch(x, k, p))
                   for lab, p in others},
               other_reads={lab: r for lab, p in others if (r := topk_reads(
                   torch, prim, x, k, p)[0]) is not None},
               sort_ms=device_ms(torch, lambda: torch.sort(x, stable=True))
               if long_row or plan.mode == "merge" else None)

    for case, (x, excl), (b, n) in scan_cases(torch, gen):
        # the mode the wrapper picks, and every other mode that takes the
        # shape: each is held against the plain version, each is timed
        plan = prim._scan_plan(b, n)
        others = [p for p in scan_plans(prim, b, n) if p.mode != plan.mode]
        want = prim.block_scan_plain(x, excl)
        for p in [plan] + others:
            got = (prim.block_scan(x, excl) if p is plan
                   else prim._scan_launch(x, excl, p))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SmokeFailure(f"block_scan {case} in {p.mode} mode: "
                                   "differs from the plain version")
        del got, want
        b_ms, b_by = bound(2 * b * n * 4, b * n)
        record("block_scan", "pqt_tpu_torch/csrc/scan.cu",
               "pqt_tpu/ops/pallas/primitives.py:115",
               f"{case} ({b},{n}) {'exclusive' if excl else 'inclusive'} "
               f"{plan.mode}",
               device_ms(torch, lambda: prim.block_scan(x, excl)),
               device_ms(torch, lambda: prim.block_scan_plain(x, excl)),
               device_ms(torch,
                         lambda: torch.cumsum(x, -1, dtype=torch.int32)),
               b_ms, b_by, 0.0, mode=plan.mode,
               other_modes={p.mode: device_ms(
                   torch, lambda: prim._scan_launch(x, excl, p))
                   for p in others},
               **scan_replays(torch, prim, x, excl, [plan] + others, gen))
        del x
        torch.cuda.empty_cache()

    for case, (payload, draw, valid, q, compact), (b, k, lp, c1, slab) in \
            rerank_cases(torch, gen):
        n, w = payload.shape
        row_bytes = 4 * w
        layout = "compact" if compact else "wide"
        pos = draw()
        ok, err = check_line_rerank(torch, ga, rr, payload, pos, valid, q,
                                    compact)
        if not ok:
            raise SmokeFailure(f"gather_rerank {case}: differs from its plain "
                               f"version or its old route (max abs error "
                               f"{err})")
        rows = ga.gather_rows(payload, pos)
        rows_err = float((rr.rerank_fused(rows, q, compact) - rr.rerank_plain(
            rows, q, compact)).abs().max())
        plan = rr._rerank_plan(b, k, w, lp, c1, payload.data_ptr(),
                               rr._sm_count(torch.cuda.current_device()))
        # cold: position sets drawn anew, whose rows together span
        # COLD_SET_BYTES, so each call's rows were last read that far back
        sets = [draw() for _ in range(
            -(-COLD_SET_BYTES // (b * k * row_bytes)))]
        touched = int(torch.unique(pos).numel())
        # in: each distinct row, the positions, the validity, the tables;
        # out: ids and distances.  About 4 flops a line part
        b_ms, b_by = bound(touched * row_bytes + b * k * (4 + 1 + 4 + 4)
                           + b * lp * c1 * 4, 4 * b * k * lp)
        record("gather_rerank", "pqt_tpu_torch/csrc/rerank.cu",
               "pqt_tpu/ops/pallas/rerank.py:84 + "
               "benchmarks/micro_gather2.py:165",
               f"{case} ({n},{w}) at ({b},{k}) c1 {c1} {layout}"
               f"{f' slabs of {slab}' if slab else ''}: "
               f"{f'staged {plan.unit} B' if plan.staged else 'unstaged'}, "
               f"table {'shared' if plan.table_smem else 'global'}, "
               f"{plan.chunks} x {plan.per_chunk} tiles",
               device_ms(torch, lambda: rr.gather_rerank(payload, pos, valid,
                                                         q, compact)),
               device_ms(torch, lambda: rr.gather_rerank_plain(
                   payload, pos, valid, q, compact)),
               None, b_ms, b_by, err, plan=plan._asdict(),
               cold_ms=rotating_ms(torch, lambda p: rr.gather_rerank(
                   payload, p, valid, q, compact), sets),
               old_route_ms=device_ms(torch, lambda: old_line_route(
                   ga, rr, payload, pos, valid, q, compact)),
               cold_old_route_ms=rotating_ms(torch, lambda p: old_line_route(
                   ga, rr, payload, p, valid, q, compact), sets))
        # the same kernel over the rows gathered first (the Pallas kernel's
        # contract), and its old route's second launch
        b_ms, b_by = bound(b * k * row_bytes + b * lp * c1 * 4 + b * k * 4,
                           4 * b * k * lp)
        record("rerank_fused", "pqt_tpu_torch/csrc/rerank.cu",
               "pqt_tpu/ops/pallas/rerank.py:84",
               f"{case} ({b},{k},{w}) c1 {c1} {layout} over gathered rows",
               device_ms(torch, lambda: rr.rerank_fused(rows, q, compact)),
               device_ms(torch, lambda: rr.rerank_plain(rows, q, compact)),
               None, b_ms, b_by, rows_err, mode=layout)
        del pos, rows, sets

    for case, (v, parts), (b, d, _) in reduce_cases(torch, gen):
        # plain mode on the squares (as the kernel was first timed), then
        # square mode on the values beside the old route (x * x, then plain
        # mode).  Integer terms below 2^16, sums below 2^24: exact in any
        # order, equal to the bit.  The encode's 32 MB inputs are timed warm
        # (repeats on one input, which stays in L2) and cold (cold_ms).  The
        # one library call for square mode, einsum, goes by a batched matmul
        # (a slow route); plain mode's sum(-1) is the fair yardstick
        sq = (v * v).contiguous()
        for square, x in ((False, sq), (True, v)):
            plan = prim._reduce_plan(b * parts, d // parts, x.data_ptr())
            want = prim.segmented_reduce_plain(x, parts, square)
            got = prim.segmented_reduce(x, parts, square=square)
            old = prim.segmented_reduce(v * v, parts) if square else want
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not (torch.equal(got, want) and torch.equal(old, want)):
                raise SmokeFailure(f"segmented_reduce {case} square={square}: "
                                   f"max abs error {err}")
            del got, old, want
            xv = x.view(b, parts, d // parts)
            cold = {}
            if b * d * 4 > COLD_SET_BYTES // 16:
                # the library call cold in plain mode; the old route in square
                cold["cold_ms"] = cold_ms(
                    torch, lambda t: prim.segmented_reduce(t, parts,
                                                           square=square), x)
                if square:
                    cold["cold_old_route_ms"] = cold_ms(
                        torch, lambda t: prim.segmented_reduce(t * t, parts),
                        x)
                else:
                    cold["cold_library_ms"] = cold_ms(
                        torch, lambda t: t.view(b, parts, -1).sum(-1), x)
            b_ms, b_by = bound(b * d * 4 + b * parts * 4,
                               b * d * (2 if square else 1))
            record("segmented_reduce", "pqt_tpu_torch/csrc/reduce.cu",
                   "pqt_tpu/ops/pallas/primitives.py:145",
                   f"{case} ({b},{d})->{parts} {plan.mode}"
                   f"{' square' if square else ''}",
                   device_ms(torch, lambda: prim.segmented_reduce(
                       x, parts, square=square)),
                   device_ms(torch, lambda: prim.segmented_reduce_plain(
                       x, parts, square)),
                   device_ms(torch, (lambda: torch.einsum("bps,bps->bp", xv,
                                                          xv))
                             if square else (lambda: xv.sum(-1))),
                   b_ms, b_by, err, mode=plan.mode, square=square, **cold,
                   **({"old_route_ms": device_ms(
                       torch, lambda: prim.segmented_reduce(v * v, parts))}
                      if square else {}))
        del v, sq

    for case, (table, idx), (b, e) in lut_cases(torch, gen):
        got = ga.lut_gather(table, idx)
        want = ga.lut_gather_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SmokeFailure(f"lut_gather {case}: differs from the plain "
                               "version")
        del got, want
        es = table.element_size()
        touched = torch.unique(idx)
        # a random lookup moves the whole 32-byte sector it falls in
        sectors = int(torch.unique(touched * es // 32).numel())
        b_ms, b_by = bound(b * e * 4 + b * e * es + touched.numel() * es, 0)
        record("lut_gather", "pqt_tpu_torch/csrc/lut.cu",
               "benchmarks/micro_gather.py:32",
               f"{case} ({table.shape[0]},) {table.dtype} at ({b},{e})",
               device_ms(torch, lambda: ga.lut_gather(table, idx)),
               device_ms(torch, lambda: ga.lut_gather_plain(table, idx)),
               device_ms(torch, lambda: table[idx]), b_ms, b_by, 0.0,
               sector_bound_ms=bound(b * e * 4 + b * e * es + sectors * 32,
                                     0)[0])
        del table, idx, touched
        torch.cuda.empty_cache()

    for case, (tab, pos, span) in gather_cases(torch, gen):
        b, k = pos.shape
        row_bytes = tab.shape[1] * tab.element_size()
        plan = ga._gather_plan(pos.numel(), row_bytes, span, tab.data_ptr())
        want = ga.gather_rows_plain(tab, pos, span)
        got = ga.gather_rows(tab, pos, span)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SmokeFailure(f"gather_rows {case}: differs from the plain "
                               "version")
        del got, want
        # one PyTorch call on the same rows: the positions of every row
        # gathered are made beforehand for the slab case
        full = (pos[..., None] + torch.arange(span, device="cuda",
                                              dtype=torch.int32)
                if span > 1 else pos)
        touched = int(torch.unique(full).numel())
        b_ms, b_by = bound(b * k * 4 + b * k * span * row_bytes
                           + touched * row_bytes, 0)
        record("gather_rows", "pqt_tpu_torch/csrc/gather.cu",
               "benchmarks/micro_gather2.py:165",
               f"{case} ({tab.shape[0]},{tab.shape[1]}) {tab.dtype} at "
               f"({b},{k}) span {span} {plan.mode} {plan.unit} B x "
               f"{plan.units}",
               device_ms(torch, lambda: ga.gather_rows(tab, pos, span)),
               device_ms(torch, lambda: ga.gather_rows_plain(tab, pos, span)),
               device_ms(torch, lambda: tab[full]), b_ms, b_by, 0.0,
               mode=plan.mode,
               sector_bound_ms=bound(b * k * 4 + b * k * span * row_bytes
                                     + sectors_touched(torch, full, row_bytes)
                                     * 32, 0)[0])
        del tab, pos, full

    for case, (tab, pos, q) in sqdist_cases(torch, gen):
        (b, k), dim = pos.shape, tab.shape[1]
        got = prim.gather_sqdist(tab, pos, q)
        want = prim.gather_sqdist_plain(tab, pos, q)
        old = old_exact_route(ga, prim, tab, pos, q)
        torch.cuda.synchronize()
        # integer terms of at most 255^2, sums below 2^24: exact in any order
        if not (torch.equal(got, want) and torch.equal(old, want)):
            raise SmokeFailure(f"gather_sqdist {case}: differs from the plain "
                               "version or from the old route")
        del got, want, old
        touched = int(torch.unique(pos).numel())
        b_ms, b_by = bound(touched * dim * tab.element_size() + b * k * 8
                           + b * dim * 4, 2 * b * k * dim)
        record("gather_sqdist", "pqt_tpu_torch/csrc/sqdist.cu",
               "benchmarks/micro_gather2.py:165 + "
               "pqt_tpu/ops/pallas/primitives.py:145",
               f"{case} ({tab.shape[0]},{dim}) {tab.dtype} at ({b},{k})",
               device_ms(torch, lambda: prim.gather_sqdist(tab, pos, q)),
               device_ms(torch, lambda: prim.gather_sqdist_plain(tab, pos, q)),
               None, b_ms, b_by, 0.0,
               old_route_ms=device_ms(
                   torch, lambda: old_exact_route(ga, prim, tab, pos, q)))
        del tab, pos, q

    for case, lp, c1 in LINE_CODE_SHAPES:
        # kernel L against its plain version (the tables' passes, then the
        # chain of passes XLA fuses in the JAX package), fed from the line
        # GEMM's own output, codes and terms equal to the bit
        n = ENCODE_CHUNK
        dot, xn, cn, p = line_terms_case(torch, gen, n, lp, c1)
        for bits in (16, 8):
            got = lc.line_codes(dot, xn, cn, p, bits)
            want = L.line_codes_plain(D.subpart_sqdist_from_terms(dot, xn, cn),
                                      p, bits)
            torch.cuda.synchronize()
            if not same_line_codes(torch, got, want):
                raise SmokeFailure(
                    f"line_codes {case} lambda {bits} bits: "
                    f"{int((got[0] != want[0]).sum())} codes and "
                    f"{int((got[1] != want[1]).sum())} terms differ from "
                    "the plain version")
            del got, want
            # in: the dot products once (as many as the tables' distances;
            # portbench/yardstick.py's count, which leaves out the 4 bytes
            # of norms a (row, part)); out: an int64 code and a float term
            # a (row, part).  8 operations a pair A < B: two subtractions, a
            # multiply, a divide, two multiplies, a subtraction, a compare
            pairs = n * lp * c1 * (c1 - 1) // 2
            b_ms, b_by = bound(n * lp * c1 * 4 + lp * c1 * c1 * 4
                               + n * lp * 12, 8 * pairs)
            record("line_codes", "pqt_tpu_torch/csrc/linecodes.cu",
                   "pqt_tpu/ops/linecodes.py:77",
                   f"{case} ({n},{lp},{c1}) lambda {bits} bits",
                   device_ms(torch, lambda: lc.line_codes(dot, xn, cn, p,
                                                          bits)),
                   device_ms(torch, lambda: L.line_codes_from_terms_plain(
                       dot, xn, cn, p, bits), reps=5),
                   None, b_ms, b_by, 0.0, dot_strides=list(dot.stride()))
        del dot, xn, cn, p
        torch.cuda.empty_cache()
    for case, p, k, vl in PART_CODE_SHAPES:
        # kernel P against its plain version (the level-2 tables op by op
        # and torch.argmin), a pick that differs a near-tie
        n = ENCODE_CHUNK
        x, cb = part_codes_case(torch, gen, n, p, k, vl)
        _, differ, near, gap = part_code_differences(torch, x, cb)
        if differ > PART_CODES_DIFFER * n * p or not near:
            raise SmokeFailure(f"part_codes {case}: {differ} codes differ "
                               f"from the plain version's (largest gap "
                               f"{gap:.3g})")
        args = D.part_norms(x, cb)
        # in: the rows, the codebook and both norms once; out: an int64 code
        # a (row, part).  A multiply-add a dimension of each distance
        b_ms, b_by = bound(n * p * vl * 4 + p * k * vl * 4 + p * k * 4
                           + n * p * 4 + n * p * 8, 2 * n * p * k * vl)
        record("part_codes", "pqt_tpu_torch/csrc/partcodes.cu",
               "pqt_tpu/models/db.py:176", f"{case} ({n},{p},{k},{vl})",
               device_ms(torch, lambda: pc.part_codes(*args)),
               device_ms(torch, lambda: D.part_codes_plain(*args), reps=5),
               None, b_ms, b_by, 0.0, differ=differ, gap=gap)
        del x, cb, args
        torch.cuda.empty_cache()
    return results, floor


# Throwaway kernels a traced call makes first, inside its profiler session.
# Late in this script's process a session lost the records of its first few
# kernels (a query's copy, first gemm and first kernel-D launch; on an H100,
# NVIDIA H100 80GB HBM3, 700 W, in eager calls and replays alike, and
# whatever time the call waited first), so those are these fills instead.
TRACE_PAD = 32
PAD_KERNEL = "FillFunctor<double>"      # no query launches a float64 fill


def pad_trace(torch):
    t = torch.empty(1, dtype=torch.float64, device="cuda")
    for _ in range(TRACE_PAD):
        t.fill_(1.0)
    torch.cuda.synchronize()


def profile_batch(torch, fn, x, reps=3):
    """Where one batch's time goes: device time by kernel (torch.profiler)
    against the host clock.  Returns a dict, or the reason it could not."""
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_trace(torch)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # by the kernel's whole name: PyTorch's elementwise kernels share
        # their first hundred characters whatever operation they run
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    PAD_KERNEL not in e.name:
                kernels[e.name] = kernels.get(e.name, 0.0) + (
                    e.device_time_total / 1e3 / reps)
    except (RuntimeError, AttributeError) as err:   # the profiler is a probe
        return {"not_measured": repr(err)}
    busy = sum(kernels.values())
    if busy <= 0:
        return {"not_measured": "the profiler recorded no device time"}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "n_kernel_names": len(kernels),
            "top_kernels_ms": [[k[:240], v] for k, v in top]}


def topk_hard_rows(torch, gen):
    """Rows on which a select is easiest to get wrong: (name, x, k)."""
    n = 16384
    levels = torch.randint(0, 6, (4, n), generator=gen,
                           device="cuda").to(torch.float32)
    levels[torch.rand((4, n), generator=gen, device="cuda") < 0.1] = \
        float("inf")
    yield "all equal", torch.full((4, n), 3.0, device="cuda"), 128
    yield "all +inf", torch.full((4, n), float("inf"), device="cuda"), 128
    zeros = torch.where(torch.rand((4, n), generator=gen, device="cuda")
                        < 0.5, 0.0, -0.0)
    zeros[:, ::5] = 1.0
    yield "+0.0 and -0.0 mixed", zeros, 128
    # 256 of -1, 1024 of 2 and the rest 5: the cut falls among the 5s
    cut = torch.full((4, n), 5.0, device="cuda")
    cut[:, ::16] = 2.0
    cut[:, 7::64] = -1.0
    yield "copies of the k-th value on both sides of the cut", cut, 2000
    yield "k = 1", levels, 1
    yield "k = n", levels[:3, :5000].contiguous(), 5000
    wide = torch.randint(0, 6, (3, 70001), generator=gen,
                         device="cuda").to(torch.float32)
    wide[:, ::9] = float("inf")
    yield "odd width 70001", wide, 256
    yield "odd width 70001, k = 1", wide, 1
    yield "B = 1", levels[:1].contiguous(), 128
    yield "B = 1, odd width 70001", wide[:1].contiguous(), 256
    # merge mode (k > 16384): 65536-wide rows
    m = 1 << 16
    yield "merge: all equal", torch.full((3, m), 3.0, device="cuda"), 32768
    yield "merge: all +inf, k = n", torch.full((3, m), float("inf"),
                                               device="cuda"), m
    # runs of equal values that straddle the 16384-pair runs and the
    # 4096-pair merge tiles
    pos = torch.arange(m, device="cuda")
    yield "merge: ties across run boundaries", ((pos + 5000) // 10000 % 3
                                                ).to(torch.float32).expand(
        2, m).contiguous(), 40000
    yield "merge: ties across run boundaries, k = n", (
        (pos // 12289) % 4).to(torch.float32).expand(2, m).contiguous(), m
    tail = torch.randint(0, 9, (2, m), generator=gen,
                         device="cuda").to(torch.float32)
    tail[:, m // 2:] = float("inf")
    yield "merge: +inf tail, k = n", tail, m
    yield "merge: +inf tail, cut in the tail", tail, 40000
    mz = torch.where(torch.rand((2, m), generator=gen, device="cuda")
                     < 0.5, 0.0, -0.0)
    mz[:, ::7] = -1.0
    yield "merge: +0.0 and -0.0 mixed", mz, 50000
    yield "merge: odd width 70001, k = 20000", wide, 20000
    # the cluster route: ties at the cut across the slices' boundaries
    # (16384 x r for 4 blocks, 8192 x r for 8), a row that is no multiple
    # of a slice, and short rows whose last slices are empty
    cross = torch.full((2, m), 5.0, device="cuda")
    cross[:, 16000:17000] = 0.0
    cross[:, 32700:32800] = 0.0
    cross[:, 49100:49200] = 1.0
    yield "cluster: ties at the cut across slices", cross, 1170
    yield "cluster: ties across slices, k = n", cross, m
    yield ("cluster: width 40000, k = 20000",
           levels.repeat(1, 3)[:2, :40000].contiguous(), 20000)
    yield ("cluster: width 1025, empty slices",
           levels[:, :1025].contiguous(), 600)


def scan_hard_rows(torch, gen):
    """Rows on which a scan is easiest to get wrong: (name, x)."""
    def ints(shape, hi=9):
        return torch.randint(0, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int32)
    yield "look-back across many tiles, rows > 1", ints((3, 5_000_011))
    yield "several long rows", ints((4, 100_003))
    yield "ragged width", ints((3, 70_001))
    yield "short rows", ints((3, 5000))
    yield "rows shorter than a warp", ints((2, 31))
    yield "one element", ints((5, 1))
    yield "all zero, long", torch.zeros((2, 1 << 20), dtype=torch.int32,
                                        device="cuda")
    yield "all zero, short", torch.zeros((256, 512), dtype=torch.int32,
                                         device="cuda")
    for b, n in ((1, 1 << 20), (2, 4096)):
        top = torch.full((b, n), (1 << 31) // n, dtype=torch.int32,
                         device="cuda")
        top[:, -1] -= 1
        yield f"row sum 2^31 - 1 at {n}", top
    # an input 4 bytes past a 16-byte boundary: every load is scalar
    flat = ints((3 * 70_001 + 1,))
    yield "input off a 16-byte boundary", flat[1:].view(3, 70_001)


def lut_hard_cases(torch, gen):
    """Lookups that are easiest to get wrong: (name, table, idx)."""
    for dtype in (torch.int32, torch.uint8):
        table = torch.randint(0, 99, (1001,), generator=gen,
                              device="cuda").to(dtype)
        yield f"ragged (3, 77) {dtype}", table, torch.randint(
            0, 1001, (3, 77), generator=gen, device="cuda",
            dtype=torch.int32)
        for n in range(1, 10):
            yield f"{n} lookups {dtype}", table, torch.randint(
                0, 1001, (n,), generator=gen, device="cuda",
                dtype=torch.int32)
        flat = torch.randint(0, 1001, (4098,), generator=gen,
                             device="cuda", dtype=torch.int32)
        yield f"indices 4 bytes past a 16-byte boundary {dtype}", table, \
            flat[1:]
    # the pair table's size, 128 KB of uint8, at 2^21 lookups
    table = (torch.rand(1 << 17, generator=gen, device="cuda") < 0.3
             ).to(torch.uint8)
    yield "128 KB uint8 table", table, torch.randint(
        0, 1 << 17, (1 << 21,), generator=gen, device="cuda",
        dtype=torch.int32)


def sqdist_hard_cases(torch, gen):
    """Inputs on which the exact distances are easiest to get wrong: (name,
    tab, pos, q, exact).  `exact`: integer rows and queries whose sums stay
    below 2^24, equal to the bit in any order; the others within rtol
    1e-5."""
    def table(n, dim, dtype=torch.uint8):
        return torch.randint(0, 256, (n, dim), generator=gen,
                             device="cuda").to(dtype)

    def pos(n, b=3, k=77):
        return torch.randint(0, n, (b, k), generator=gen, device="cuda",
                             dtype=torch.int32)

    def queries(b, dim, fractional=False):
        q = torch.randint(0, 256, (b, dim), generator=gen,
                          device="cuda").to(torch.float32)
        if fractional:
            q += torch.rand((b, dim), generator=gen, device="cuda") - 0.5
        return q

    for dim, unit, exact in ((960, "16-byte units, two a lane", False),
                             (24, "8-byte units", True),
                             (100, "4-byte units", True),
                             (13, "1-byte units", True),
                             (2048, "units past the register slice", False)):
        yield f"dim {dim} uint8 ({unit})", table(5000, dim), pos(5000), \
            queries(3, dim), exact
    yield "dim 960 fractional queries", table(5000, 960), pos(5000), \
        queries(3, 960, True), False
    yield "dim 960 float32 (units past the register slice)", table(
        2000, 960, torch.float32), pos(2000), queries(3, 960), False
    yield "dim 3 float32 (4-byte units)", table(5000, 3, torch.float32), \
        pos(5000), queries(3, 3), True
    frac = table(5000, 128, torch.float32)
    frac += torch.rand(frac.shape, generator=gen, device="cuda") - 0.5
    yield "dim 128 fractional float32 rows", frac, pos(5000), \
        queries(3, 128), False
    # a uint8 table 8 bytes past a 16-byte boundary: 8-byte units
    flat = torch.randint(0, 256, (5000 * 128 + 8,), generator=gen,
                         device="cuda", dtype=torch.uint8)
    yield "dim 128 off a 16-byte boundary", flat[8:].view(5000, 128), \
        pos(5000), queries(3, 128), True
    tab = table(5000, 128)
    last = pos(5000, 4, 1000)
    last[:, ::3] = 4999
    yield "positions at row N - 1", tab, last, queries(4, 128), True
    yield "every position 0", tab, torch.zeros((4, 1000), dtype=torch.int32,
                                               device="cuda"), \
        queries(4, 128), True
    yield "B = 1, K = 1", tab, pos(5000, 1, 1), queries(1, 128), True
    yield "fractional queries at dim 128", tab, pos(5000, 8, 513), \
        queries(8, 128, True), False


def reduce_hard_cases(torch, gen):
    """Segment sums that are easiest to get wrong: (name, x, parts, square,
    exact).  Every segment length of 1 to 130 in both modes, on an input
    that starts on a 16-byte boundary (vec4 mode where seg % 4 == 0) and one
    4 bytes past it (scalar mode), with integer values (sums below 2^24,
    equal to the bit); then fractional signed values (within 1e-5 of the
    sum of the terms' magnitudes), ragged
    row counts and segments longer than a warp's loads."""
    for seg in range(1, 131):
        parts, b = 1 + seg % 3, 1 + seg % 7
        flat = torch.randint(-255, 256, (b * parts * seg + 1,), generator=gen,
                             device="cuda").to(torch.float32)
        for off in (0, 1):
            x = flat[off:off + b * parts * seg].view(b, parts * seg)
            for square in (False, True):
                yield f"seg {seg} offset {4 * off} B", x, parts, square, True
    frac = torch.randn((37, 4 * 96), generator=gen, device="cuda") * 100
    for parts in (1, 3, 4, 32, 96):
        for square in (False, True):
            yield "fractional", frac, parts, square, False
    long_rows = torch.randint(0, 9, (3, 3000), generator=gen,
                              device="cuda").to(torch.float32)
    for parts in (1, 3):
        yield "segments of 3000 and 1000", long_rows, parts, True, True


def gather_hard_cases(torch, gen):
    """Row gathers that are easiest to get wrong: (name, tab, pos, span).
    72-byte payload rows, 40-byte SIFT1M payload rows, 8-byte extent rows,
    128-byte vectors, rows of 1, 3, 5 and 13 bytes, of 3 int16 and of 3
    int32, in spans of 1, 2, 5, 8 and 32, from tables that start on a
    16-byte boundary or 4 or 8 bytes past it, with
    rows 0 and N - span among the positions, and ragged position counts."""
    n = 3000
    for dtype, width in ((torch.int32, 18), (torch.int32, 10),
                         (torch.int32, 2), (torch.int32, 3),
                         (torch.uint8, 128), (torch.uint8, 1),
                         (torch.uint8, 3), (torch.uint8, 5),
                         (torch.uint8, 13), (torch.int16, 3)):
        es = torch.tensor([], dtype=dtype).element_size()
        flat = torch.randint(-99 if dtype != torch.uint8 else 0, 99,
                             (n * width + 16 // es,), generator=gen,
                             device="cuda").to(dtype)
        for off_bytes in (0, 4, 8):
            if off_bytes % es:
                continue
            tab = flat[off_bytes // es:off_bytes // es + n * width].view(
                n, width)
            for span in (1, 2, 5, 8, 32):
                pos = torch.randint(0, n - span + 1, (3, 77), generator=gen,
                                    device="cuda", dtype=torch.int32)
                pos[0, :2] = torch.tensor([0, n - span])
                pos[2, -1] = n - span
                yield (f"{width} x {dtype} offset {off_bytes} B", tab, pos,
                       span)
    tab = torch.randint(0, 99, (n, 18), generator=gen, device="cuda",
                        dtype=torch.int32)
    for k in range(1, 10):
        yield f"{k} positions", tab, torch.randint(
            0, n, (k,), generator=gen, device="cuda", dtype=torch.int32), 1


def rerank_hard_cases(torch, gen):
    """Line re-ranks that are easiest to get wrong: (name, payload,
    positions, valid, q, compact).  Ragged K (1, 255, 256, 257, 1000), one
    query, rows 0 and N - 1 only, every slot invalid, positions outside the
    payload, payloads 4 and 8 bytes off a 16-byte boundary (4- and 8-byte
    copies), 16-byte rows (16-byte copies), odd word counts (3 and 5 words,
    one word a load), more queries than the card holds blocks (several
    tiles a block) and than a grid's 65535 rows, and every kernel mode:
    tables of 64 KB in shared memory, of 100 KB from global memory beside
    staged rows, of 240 KB with 968-byte rows unstaged, and unstaged
    488-byte compact rows with their table in shared memory."""
    n = 3000

    def pos(b, k, rows=n):
        return torch.randint(0, rows, (b, k), generator=gen, device="cuda",
                             dtype=torch.int32)

    def ok(b, k):
        return torch.rand((b, k), generator=gen, device="cuda") < 0.8

    def tables(b, lp, c1=16):
        return torch.rand((b, lp, c1), generator=gen, device="cuda") * 5e3

    base = line_payload(torch, gen, n, 16, 16, True)            # 40-byte rows
    for k in (1, 255, 256, 257, 1000):
        yield f"ragged K = {k}", base, pos(3, k), ok(3, k), tables(3, 16), \
            True
    yield "B = 1", base, pos(1, 777), ok(1, 777), tables(1, 16), True
    ends = pos(2, 600)
    ends[:, 0::2], ends[:, 1::2] = 0, n - 1
    yield "rows 0 and N - 1 only", base, ends, ok(2, 600), tables(2, 16), True
    yield "every slot invalid", base, pos(2, 600), torch.zeros(
        (2, 600), dtype=torch.bool, device="cuda"), tables(2, 16), True
    out = pos(2, 600)
    out[0, :4] = torch.tensor([-1, n, 10 ** 9, -10 ** 9], device="cuda")
    yield "positions outside the payload", base, out, ok(2, 600), \
        tables(2, 16), True
    flat = torch.empty(n * 10 + 4, dtype=torch.int32, device="cuda")
    off4 = flat[1:1 + n * 10].view(n, 10)
    off4.copy_(base)
    yield "payload 4 bytes off a 16-byte boundary", off4, pos(3, 1000), \
        ok(3, 1000), tables(3, 16), True
    w4 = line_payload(torch, gen, n, 2, 16, False)              # 16-byte rows
    yield "16-byte rows", w4, pos(3, 1000), ok(3, 1000), tables(3, 2), False
    flat = torch.empty(n * 4 + 2, dtype=torch.int32, device="cuda")
    off8 = flat[2:2 + n * 4].view(n, 4)
    off8.copy_(w4)
    yield "16-byte rows 8 bytes off a 16-byte boundary", off8, pos(3, 1000), \
        ok(3, 1000), tables(3, 2), False
    for lp in (2, 5):                                           # 3, 5 words
        yield f"compact lp {lp}", line_payload(torch, gen, n, lp, 16, True), \
            pos(3, 1000), ok(3, 1000), tables(3, lp), True
    yield "2000 queries of 2000", base, pos(2000, 2000), ok(2000, 2000), \
        tables(2000, 16), True
    yield "70000 queries of 8", base, pos(70000, 8), ok(70000, 8), \
        tables(70000, 16), True
    for lp, c1, compact in ((64, 256, False), (100, 256, False),
                            (240, 256, False), (240, 16, True)):
        yield f"lp {lp} c1 {c1} {'compact' if compact else 'wide'}", \
            line_payload(torch, gen, 20000, lp, c1, compact), \
            pos(4, 1500, 20000), ok(4, 1500), tables(4, lp, c1), compact


def check_other_paths(torch):
    """Kernel paths beyond the query paths' shapes, for correctness only
    (not timed), each in the mode the wrapper picks and in every mode that
    takes it: top-k rows that are hard for a select; scans that are hard
    for the look-back (many tiles over several rows, all-zero rows, a row
    summing to 2^31 - 1, ragged widths, an input off a 16-byte boundary,
    50 back-to-back onepass scans); lookups of 1 to 9 elements, of a ragged
    shape, from indices off a 16-byte boundary (4097 of them) and from a
    128 KB table; segment sums of every length from 1 to 130 in both
    modes, aligned (vec4) and 4 bytes off (scalar) (reduce_hard_cases);
    row gathers in every unit and span, from tables off a 16-byte boundary,
    and rows outside the table (zeros; gather_hard_cases); the line
    re-rank by position in every kernel mode and copy unit, at ragged
    shapes and positions outside the payload (rerank_hard_cases); and the exact
    distances in every load unit, past the query slice a lane keeps in
    registers, at the table's last row and its first, with fractional
    queries and rows, and a position outside the table (NaN); and kernel
    L's line-code selection on line_code_hard_cases at both lambda widths,
    codes and terms equal to the bit; P's part codes on
    part_code_hard_cases, equal to the bit where every distance is exact,
    else at most one code in 10^4 differs, at a near-tie."""
    from pqt_tpu_torch.ops import linecodes as L
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import linecodes as lc
    from pqt_tpu_torch.ops.cuda import primitives as prim
    from pqt_tpu_torch.ops.cuda import rerank as rr

    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, x, k in topk_hard_rows(torch, gen):
        n = x.shape[1]
        want = prim.bitonic_topk_plain(x, k)
        got = {"default": prim.bitonic_topk(x, k)}
        for label, p in topk_plans(prim, n, k, every=True):
            got[label] = prim._topk_launch(x, k, p)
        for label, (v, i) in got.items():
            if not (torch.equal(v, want[0]) and torch.equal(i, want[1])):
                raise SmokeFailure(f"bitonic_topk {name} {tuple(x.shape)}->"
                                   f"{k} ({label}) differs")
    for name, x in scan_hard_rows(torch, gen):
        b, n = x.shape
        for excl in (False, True):
            want = prim.block_scan_plain(x, excl)
            got = {"default": prim.block_scan(x, excl)}
            for p in scan_plans(prim, b, n):
                got[p.mode] = prim._scan_launch(x, excl, p)
            for mode, out in got.items():
                if not torch.equal(out, want):
                    raise SmokeFailure(f"block_scan {name} ({b},{n}) "
                                       f"{'exclusive' if excl else ''} "
                                       f"({mode} mode) differs")
    # back-to-back onepass scans on one stream, no synchronisation between
    # them: a stale status word or a wrong epoch shows as a wrong sum
    lengths = torch.randint(4097, 300_000, (50,), generator=gen,
                            device="cuda").tolist()
    lengths[:3] = [900_001, 5, 40_000]
    runs = []
    for i, n in enumerate(lengths):
        x = torch.randint(0, 5, (1 + i % 3, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        runs.append((x, prim._scan_launch(
            x, i % 2 == 1, prim._scan_plan(x.shape[0], n, "onepass"))))
    for i, (x, got) in enumerate(runs):
        if not torch.equal(got, prim.block_scan_plain(x, i % 2 == 1)):
            raise SmokeFailure(f"block_scan: back-to-back onepass scan {i} "
                               f"{tuple(x.shape)} differs")
    del runs
    for name, x, parts, square, exact in reduce_hard_cases(torch, gen):
        b, d = x.shape
        want = prim.segmented_reduce_plain(x, parts, square)
        got = prim.segmented_reduce(x, parts, square=square)
        # fractional sums within 1e-5 of the sum of the terms' magnitudes
        # (signed terms cancel, so a relative tolerance on the sum alone
        # says nothing of the order of the additions)
        tol = 1e-5 * prim.segmented_reduce_plain(x.abs(), parts, square)
        ok = (torch.equal(got, want) if exact else
              bool(((got - want).abs() <= tol).all()))
        if not ok:
            raise SmokeFailure(f"segmented_reduce {name} ({b},{d})->{parts} "
                               f"square={square} differs")
    for name, table, idx in lut_hard_cases(torch, gen):
        if not torch.equal(ga.lut_gather(table, idx),
                           ga.lut_gather_plain(table, idx)):
            raise SmokeFailure(f"lut_gather {name} differs")
    for name, tab, pos, span in gather_hard_cases(torch, gen):
        if not torch.equal(ga.gather_rows(tab, pos, span),
                           ga.gather_rows_plain(tab, pos, span)):
            raise SmokeFailure(f"gather_rows {name} {tuple(tab.shape)} "
                               f"{tab.dtype} span {span} differs")
    # rows outside the table read nothing and yield zeros: positions before
    # it, at its last rows (a slab running past the end) and past it
    tab = torch.randint(1, 99, (50, 18), generator=gen, device="cuda",
                        dtype=torch.int32)
    for span in (1, 3, 32):
        pos = torch.tensor([[-40, -1, 0, 48, 49, 50, 10 ** 9]],
                           dtype=torch.int32, device="cuda")
        rows = pos[..., None].long() + torch.arange(span, device="cuda")
        inside = (rows >= 0) & (rows < 50)
        want = torch.where(inside[..., None], tab[rows.clamp(0, 49)], 0)
        if span == 1:
            want = want[..., 0, :]
        if not torch.equal(ga.gather_rows(tab, pos, span), want):
            raise SmokeFailure(f"gather_rows: rows outside the table, "
                               f"span {span}, differ")
    for name, tab, pos, q, exact in sqdist_hard_cases(torch, gen):
        got = prim.gather_sqdist(tab, pos, q)
        want = prim.gather_sqdist_plain(tab, pos, q)
        ok = (torch.equal(got, want) if exact else
              torch.allclose(got, want, rtol=1e-5, atol=0.0))
        if not ok:
            raise SmokeFailure(f"gather_sqdist {name} {tuple(tab.shape)} at "
                               f"{tuple(pos.shape)} differs (max abs error "
                               f"{float((got - want).abs().max())})")
    for name, payload, pos, valid, q, compact in rerank_hard_cases(torch,
                                                                   gen):
        ok, err = check_line_rerank(torch, ga, rr, payload, pos, valid, q,
                                    compact)
        if not ok:
            raise SmokeFailure(f"gather_rerank {name} {tuple(payload.shape)} "
                               f"at {tuple(pos.shape)} differs (max abs "
                               f"error {err})")
    for name, dot, xn, cn, p in line_code_hard_cases(torch, gen):
        for bits in (16, 8):
            if not same_line_codes(
                    torch, lc.line_codes(dot, xn, cn, p, bits),
                    L.line_codes_from_terms_plain(dot, xn, cn, p, bits)):
                raise SmokeFailure(f"line_codes {name} {tuple(dot.shape)} "
                                   f"{dot.stride()} lambda {bits} bits "
                                   "differs")
    for name, x, cb, exact in part_code_hard_cases(torch, gen):
        _, differ, near, gap = part_code_differences(torch, x, cb)
        allowed = 0 if exact else max(1, PART_CODES_DIFFER * x.shape[0])
        if differ > allowed or not near:
            raise SmokeFailure(f"part_codes {name} {tuple(x.shape)} "
                               f"{tuple(cb.shape)}: {differ} codes differ "
                               f"(largest gap {gap:.3g})")
    # a position outside the table reads nothing and yields NaN
    tab, q = torch.zeros((10, 128), dtype=torch.uint8, device="cuda"), \
        torch.ones((1, 128), device="cuda")
    got = prim.gather_sqdist(tab, torch.tensor([[0, -1, 10, 9]],
                                               dtype=torch.int32,
                                               device="cuda"), q)
    if not (torch.equal(got[0, ::3], torch.full((2,), 128.0, device="cuda"))
            and bool(got[0, 1:3].isnan().all())):
        raise SmokeFailure(f"gather_sqdist: positions outside the table "
                           f"gave {got.tolist()}")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phases 4 and 5: the query paths at full width
# ---------------------------------------------------------------------------

def counters():
    """Every kernel wrapper, each with its `launches` count."""
    from pqt_tpu_torch.utils.graphs import kernel_wrappers
    return kernel_wrappers()


def reset_launches(torch):
    torch.cuda.synchronize()
    for c in counters():
        c.launches = 0
    top, rerank = counters()[0], counters()[2]
    top.mode_launches = dict.fromkeys(top.mode_launches, 0)
    top.cluster_launches = 0
    rerank.wide_launches = 0


def launch_counts():
    """The counts since the last reset, with kernel A's by mode and route
    and kernel C's wide-layout ones."""
    top, rerank = counters()[0], counters()[2]
    launches = {c.__name__: c.launches for c in counters()}
    launches.update({f"bitonic_topk:{m}": n
                     for m, n in top.mode_launches.items()})
    launches["rerank_fused:wide"] = rerank.wide_launches
    launches["bitonic_topk:cluster"] = top.cluster_launches
    return launches


def read_launches(label, required, modes=()):
    """launch_counts(), printed; fails if a kernel of the path, or a mode
    in `modes` ("bitonic_topk:merge", "bitonic_topk:cluster" -- kernel A's
    launches on the cluster route --, "rerank_fused:wide"), has none."""
    launches = launch_counts()
    print(f"launches on the {label}: " + json.dumps(launches), flush=True)
    for name in tuple(required) + tuple(modes):
        if launches[name] == 0:
            raise SmokeFailure(f"{name} was never launched by the {label}")
    return launches


def differs_from_reference(label, launches, recall=None):
    """What of a path's launch counts (and recall) differs from the
    reference run's; prints the verdict."""
    if label not in REFERENCE_LAUNCHES or (
            recall is not None and label not in REFERENCE_RECALL):
        print(f"{label}: no reference run recorded; launches "
              f"{[launches.get(k) for k in LAUNCH_KEYS]}, recall "
              f"{json.dumps(recall)}", flush=True)
        return [f"{label}: no reference run recorded"]
    want = dict(zip(LAUNCH_KEYS, REFERENCE_LAUNCHES[label]))
    diffs = [f"{label} launches of {k}: {launches.get(k)} (reference {v})"
             for k, v in want.items() if launches.get(k) != v]
    if recall is not None:
        ref = REFERENCE_RECALL[label]
        diffs += [f"{label} {k}: {recall.get(k)} (reference {v})"
                  for k, v in ref.items() if recall.get(k) != v]
        diffs += [f"{label} {k}: not in the reference run" for k in recall
                  if k not in ref]
    print(f"{label}: launch counts{' and recall' if recall else ''} "
          f"{'differ from' if diffs else 'equal'} the reference run's"
          + (f": {diffs}" if diffs else ""), flush=True)
    return diffs


def entry(fn, eager):
    """An entry point as users call it (replays of its CUDA graphs), or
    with `eager` its eager body."""
    return fn.__wrapped__ if eager else fn


def query_modes(P, cfg, tree, db, names, eager=False):
    modes = {
        "exact": lambda x: entry(P.query_knn, eager)(cfg, tree, db, x, K,
                                                     True),
        "line": lambda x: entry(P.query_knn, eager)(cfg, tree, db, x, K),
        "refine": lambda x: entry(P.query_knn_refine, eager)(
            cfg, tree, db, x, K),
        "candidates": lambda x: entry(P.query_candidates, eager)(
            cfg, tree, db, x),
        "big_line": lambda x: entry(P.query_big_knn, eager)(
            cfg, tree, db, x, K, 256),
        "big_perfect": lambda x: entry(P.query_big_knn_perfect, eager)(
            cfg, tree, db, x, K, 8, 256),
    }
    return {n: modes[n] for n in names}


def serve(torch, modes, qd, batch=BATCH):
    """Every mode over the queries twice, in batches, after one warm-up
    batch.  QPS is every query of the window over the window's whole time,
    so a stall inside it counts; per-batch percentiles are reported beside
    it.  Returns (the first pass's outputs, latency) by mode."""
    outputs, latency = {}, {}
    n_queries = qd.shape[0]
    for name, fn in modes.items():
        fn(qd[:batch])                        # warm-up
        samples, outs = [], []
        torch.cuda.synchronize()
        t_window = time.perf_counter()
        for rep in range(2):
            for s in range(0, n_queries, batch):
                t1 = time.perf_counter()
                out = fn(qd[s:s + batch])
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t1)
                if rep == 0:
                    outs.append(out)
        window_s = time.perf_counter() - t_window
        outputs[name] = outs
        latency[name] = {"qps": 2 * n_queries / window_s,
                         "p50_ms": float(np.percentile(samples, 50)) * 1e3,
                         "p90_ms": float(np.percentile(samples, 90)) * 1e3,
                         "max_ms": max(samples) * 1e3, "batch": batch,
                         "queries": 2 * n_queries,
                         "batch_ms": [t * 1e3 for t in samples]}
    return outputs, latency


def path_recall(torch, label, outputs, gt):
    """Recall of the modes a path served, against the exact neighbours:
    R@1, R@10 and the top-10 intersection of every result mode, candidate
    recall of the candidate set."""
    from pqt_tpu_torch.utils.metrics import (candidate_recall,
                                             intersection_at, recall_at)
    metrics = {}
    for name, outs in outputs.items():
        if name == "candidates":
            cand = torch.cat([o[0] for o in outs]).cpu().numpy()
            valid = torch.cat([o[1] for o in outs]).cpu().numpy()
            metrics["candidate_recall"] = candidate_recall(cand, valid, gt)
            continue
        ids = torch.cat([o.indices for o in outs]).cpu().numpy()
        dists = torch.cat([o.dists for o in outs]).cpu().numpy()
        if ids.shape != (gt.shape[0], K) or not np.isfinite(
                dists[ids >= 0]).all():
            raise SmokeFailure(f"{label} {name}: bad result shape or "
                               "distances")
        for key, v in recall_at(ids, gt, (1, 10)).items():
            metrics[f"{name}_{key}"] = v
        metrics[f"{name}_top10_intersection"] = intersection_at(
            ids, gt, (10,))["top10_intersection"]
    return metrics


def report(label, metrics, latency, reference, ref_name,
           thresholds=THRESHOLDS):
    """Print a path's recall beside its limits and reference, and its
    serving numbers; returns the metrics below their limits."""
    print(f"-- {label}", flush=True)
    for key, lim in thresholds.items():
        if key in metrics:
            print(f"{key:30s} {metrics[key]:.4f}  (threshold {lim}, "
                  f"{ref_name} {reference.get(key, 'not run')})", flush=True)
    for name, lat in latency.items():
        print(f"{name:12s} QPS {lat['qps']:.0f} ({lat['queries']} queries "
              f"in batches of {lat['batch']})  batch latency p50 "
              f"{lat['p50_ms']:.3f} p90 {lat['p90_ms']:.3f} max "
              f"{lat['max_ms']:.3f} ms", flush=True)
    return [f"{label} {k}" for k, lim in thresholds.items()
            if k in metrics and metrics[k] < lim]


def serve_path(torch, label, modes, qd, required, need=(), batch=BATCH,
               eager=None, partner=None, **info):
    """Serve one path with the launch counts reset just before it and read
    just after it.  With `eager` (the same modes through the entry points'
    eager bodies), serve those too by the same protocol, and hold the
    replays to them (`graph_checks`; `partner` is another path's replay to
    alternate with).  The train and build graphs captured before are freed
    first: serving needs none of their pools."""
    clear_build_graphs()
    before = {id(e) for e in graph_entries()}
    reset_launches(torch)
    out, lat = serve(torch, modes, qd, batch)
    path = dict(launches=read_launches(label, required, need),
                serving=lat, outputs=out, modes=modes, **info)
    if eager is None:
        return path
    reset_launches(torch)
    eager_out, path["eager_serving"] = serve(torch, eager, qd, batch)
    eager_launches = read_launches(f"{label} (eager bodies)", required, need)
    if eager_launches != path["launches"]:
        raise SmokeFailure(f"{label}: the eager bodies' launch counts differ "
                           "from the replays'")
    path.update(graph_checks(torch, label, modes, eager, out, eager_out,
                             qd, batch, partner, before, lat,
                             path["eager_serving"]))
    return path


# ---------------------------------------------------------------------------
# the compiled query programs: every path of phases 4-7 and 9 serves through
# the graphed entry points (a CUDA graph a static key, replayed) and through
# their eager bodies by the same protocol
# ---------------------------------------------------------------------------

# replays of one batch a mode, in alternation with the path's other modes'
# graphs (and a partner path's), each equal to the first
ALTERNATIONS = 200
# The hand-written kernels a profiler trace names, by the wrapper that
# launches them: one kernel of these names a wrapper launch.  Kernel A's
# merge mode adds merge passes and, when it keeps fewer than the whole
# row, a select (radix_select_kernel<items, resident, true>), which
# MERGE_EXTRA matches; they are not counted.
TRACE_KERNELS = {
    "bitonic_topk": ("bitonic_sort_kernel", "radix_select_kernel",
                     "run_sort_kernel", "cluster_topk_kernel"),
    "block_scan": ("scan_rows_kernel", "scan_onepass_kernel"),
    "rerank_fused": ("gather_rerank_kernel",),
    "segmented_reduce": ("reduce_vec4_kernel", "reduce_scalar_kernel"),
    "lut_gather": ("lut_kernel",),
    "gather_rows": ("gather_rows_kernel", "gather_long_kernel"),
    "gather_sqdist": ("gather_sqdist_kernel",),
    "line_codes": ("line_codes_fixed_kernel", "line_codes_any_kernel"),
    "part_codes": ("part_codes_kernel",),
}
MERGE_EXTRA = r"merge_pass_kernel|radix_select_kernel<\d+, \w+, true>"


GRAPHED = ("query_knn", "query_candidates", "query_knn_refine",
           "query_big_knn", "query_big_knn_perfect", "query_knn_split",
           "query_multi_knn")


# the graphed sharded query steps made so far (`sharded_modes`): each keeps
# its graphs in its own cache, as the JAX package's mapped_cache
SHARDED_STEPS = []


def graph_entries():
    """Every captured entry of the package's graphed entry points and of
    the sharded steps."""
    import pqt_tpu_torch as P
    return [e for name in GRAPHED for e in getattr(P, name).graphs.values()
            ] + [e for fn in SHARDED_STEPS for e in fn.graphs.values()]


def clear_sharded_graphs():
    """Drop the sharded steps and their graphs (before their process group
    is destroyed: a graph that captured its collectives must not outlive
    it), printing what they held."""
    held = sum(e.bytes for fn in SHARDED_STEPS
               for e in fn.graphs.values()) / 2 ** 20
    for fn in SHARDED_STEPS:
        fn.graphs.clear()
    SHARDED_STEPS.clear()
    print(f"sharded steps' graphs cleared: {held:.1f} MiB freed", flush=True)


def clear_graphs():
    """Drop every captured graph (and its pool), printing what they held."""
    import pqt_tpu_torch as P
    clear_sharded_graphs()
    held = sum(e.bytes for e in graph_entries()) / 2 ** 20
    for name in GRAPHED:
        getattr(P, name).graphs.clear()
    print(f"graph cache cleared: {held:.1f} MiB freed", flush=True)
    clear_build_graphs()


# ---------------------------------------------------------------------------
# the train and build side's compiled programs: the chunk encoder, the
# data-parallel encode and k-means step, the Lloyd steps and the k-means++
# picks, each replayed from its CUDA graphs and held to its eager body
# (graphs.eager()) to the bit
# ---------------------------------------------------------------------------

# the data-parallel k-means steps made so far: each keeps its graphs
DP_STEPS = []
TREE_LEAVES = ("cb1", "cb2", "centroids_full", "pair_dists")
DB_LEAVES = ("prefix", "counts", "payload", "pair_occ", "vectors", "prefix2")
# the Lloyd steps replayed between two reads of `done`, swept on the
# configuration's own 30-iteration train (models/kmeans.py LLOYD_BLOCK)
LLOYD_BLOCKS = (1, 2, 4, 8)
ENCODE_CHUNK = 65536            # the builds' default encode chunk
CHUNK_REPS = 20
UPLOAD_REPS = 3                 # warm builds timed a side, staged and serial


def build_caches():
    """{program: its graph cache} of the train and build side."""
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.models import kmeans as KM
    return {"chunk_encoder": DB.chunk_encoder.graphs,
            "chunk_codes": DB.chunk_codes.graphs,
            "lloyd_step": KM._lloyd_converge.graphs,
            "kmeanspp_pick": KM._kmeanspp_init.graphs,
            **{f"dp_kmeans_step{i}": step.graphs
               for i, step in enumerate(DP_STEPS)}}


def key_shapes(key):
    """The shapes a train or build graph's key holds."""
    if key[0] in ("lloyd", "pick"):
        return f"data {list(key[1])}, centres {list(key[2])}"
    named = [f"{p[0]} {list(p[1])}" for p in key if isinstance(p, tuple)
             and len(p) == 4 and p[0] in ("chunk", "id_offset")]
    return ", ".join(named) or f"rows over {len(key[0][1])} entries"


def build_graphs_report(label):
    """Each train and build graph key captured so far, printed with its
    capture seconds, pool MiB and replays."""
    rows = [{"program": name, "key": key_shapes(key),
             "capture_s": e.capture_s, "mib": e.bytes / 2 ** 20,
             "replays": e.replays}
            for name, cache in build_caches().items()
            for key, e in cache.items()]
    for r in rows:
        print(f"  graph of {label}: {r['program']} ({r['key']}): capture "
              f"{r['capture_s']:.4f} s, {r['mib']:.1f} MiB, {r['replays']} "
              "replays", flush=True)
    return rows


def clear_build_graphs():
    """Drop the train and build side's graphs (and their pools)."""
    held = sum(e.bytes for c in build_caches().values()
               for e in c.values()) / 2 ** 20
    for cache in build_caches().values():
        cache.clear()
    DP_STEPS.clear()
    if held:
        print(f"train and build graphs cleared: {held:.1f} MiB freed",
              flush=True)


def same_leaves(torch, a, b, fields):
    """Whether two trees or databases hold equal tensors in `fields`."""
    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        return x.dtype == y.dtype and torch.equal(x, y)
    return all(same(getattr(a, f), getattr(b, f)) for f in fields)


def same_npz(a, b):
    """Whether two chunk files hold the same arrays, to the bit."""
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
            for k in x.files)


def timed(torch, fn):
    """(fn(), its seconds to a synchronisation of the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trained(torch, P, cfg, rows):
    """(tree, seconds, Lloyd steps run)."""
    from pqt_tpu_torch.models import kmeans as KM
    before = KM.lloyd_steps["run"]
    tree, seconds = timed(torch, lambda: P.train_tree(cfg, rows,
                                                      device="cuda"))
    return tree, seconds, KM.lloyd_steps["run"] - before


def p50_ms(torch, fn, x, reps=CHUNK_REPS):
    """The median of `reps` calls of fn(x), each to a synchronisation."""
    fn(x)
    times = []
    for _ in range(reps):
        times.append(timed(torch, lambda: fn(x))[1] * 1e3)
    return float(np.median(times))


def train_build_phase(torch, P, cfg, data, tree, db, times):
    """Phase 4's train and build again through their eager bodies, held to
    the replayed ones to the bit (the same tree builds both databases);
    then the configuration's own kmeans_iters (30) on all N_TRAIN rows:
    replayed (its first call capturing), eager, and replayed with each
    LLOYD_BLOCK of LLOYD_BLOCKS, every tree equal to the bit.  Prints the
    times and Lloyd steps beside the card's name and power limit, and
    each graph key's capture seconds and pool."""
    from pqt_tpu_torch.models import kmeans as KM
    from pqt_tpu_torch.utils import graphs as G
    card = card_line()
    out = dict(times, graphs=build_graphs_report("phase 4's train and build"))
    bcfg = cfg.replace(pair_filter=True)
    with G.eager():
        etree, out["train_eager_s"], out["train_eager_steps"] = trained(
            torch, P, cfg, data[:N_TRAIN])
        edb, out["build_eager_s"] = timed(torch, lambda: P.build_database(
            bcfg, tree, data, keep_vectors=True, device="cuda"))
    tree_eq = same_leaves(torch, tree, etree, TREE_LEAVES)
    db_eq = same_leaves(torch, db, edb, DB_LEAVES)
    del edb, etree
    print(f"phase 4 train (kmeans_iters {cfg.kmeans_iters}, "
          f"{cfg.train_subsample} of {N_TRAIN} rows): replayed "
          f"{out['train_s']:.4f} s ({out['train_steps']} Lloyd steps), "
          f"eager {out['train_eager_s']:.4f} s ({out['train_eager_steps']} "
          f"steps); build of {N_DB} rows: replayed {out['build_s']:.4f} s, "
          f"eager {out['build_eager_s']:.4f} s; the trees "
          f"{'equal' if tree_eq else 'DIFFER'}, the databases (every leaf, "
          f"pair_occ included) {'equal' if db_eq else 'DIFFER'} to the bit "
          f"[{card}]", flush=True)
    if not (tree_eq and db_eq):
        raise SmokeFailure("phase 4: a replayed train or build differs from "
                           "its eager body's")
    clear_build_graphs()

    own = cfg.replace(kmeans_iters=P.SIFT1M_CONFIG.kmeans_iters,
                      train_subsample=P.SIFT1M_CONFIG.train_subsample)
    rows = data[:N_TRAIN]
    t30 = {"kmeans_iters": own.kmeans_iters, "rows": N_TRAIN,
           "default_block": KM.LLOYD_BLOCK}
    first, t30["first_s"], t30["first_steps"] = trained(torch, P, own, rows)
    with G.eager():
        want, t30["eager_s"], t30["eager_steps"] = trained(torch, P, own,
                                                           rows)
    equal = same_leaves(torch, first, want, TREE_LEAVES)
    t30["blocks"] = {}
    try:
        for m in LLOYD_BLOCKS:
            KM.LLOYD_BLOCK = m
            got, seconds, steps = trained(torch, P, own, rows)
            same = same_leaves(torch, got, want, TREE_LEAVES)
            equal = equal and same
            t30["blocks"][m] = {"s": seconds, "steps": steps,
                                "wasted": steps - t30["eager_steps"],
                                "equal": same}
    finally:
        KM.LLOYD_BLOCK = t30["default_block"]
    sweep = "; ".join(f"block {m}: {b['s']:.4f} s, {b['steps']} steps "
                      f"({b['wasted']} past the eager loop's)"
                      for m, b in t30["blocks"].items())
    print(f"train at the configuration's own kmeans_iters "
          f"{own.kmeans_iters} on {N_TRAIN} rows: eager {t30['eager_s']:.4f}"
          f" s ({t30['eager_steps']} Lloyd steps); replayed, first call with "
          f"its captures {t30['first_s']:.4f} s ({t30['first_steps']} "
          f"steps); {sweep}; every tree {'equal' if equal else 'NOT equal'} "
          f"to the eager tree to the bit [{card}]", flush=True)
    t30["graphs"] = build_graphs_report("the 30-iteration train")
    clear_build_graphs()
    if not equal:
        raise SmokeFailure("the 30-iteration train: a replayed tree differs "
                           "from the eager one")
    out["own_iters"] = t30
    return out


def serial_build(torch, cfg, tree, data, keep_vectors,
                 encode_chunk=ENCODE_CHUNK):
    """A frozen copy of build_database's body before its chunked upload:
    every row up first in one pageable copy (without keep_vectors, each
    chunk in one), then the chunk encoder over the chunks, then the CSR
    assembly."""
    from pqt_tpu_torch.models import db as DB
    dev = tree.cb1.device
    n = data.shape[0]
    pair_occ = (torch.zeros((cfg.p // 2, cfg.part_radix ** 2),
                            dtype=torch.uint8, device=dev)
                if cfg.pair_filter_enabled else None)
    vectors = torch.as_tensor(data, device=dev) if keep_vectors else None
    bins_l, packed_l = [], []
    for s in range(0, n, encode_chunk):
        chunk = (vectors[s:s + encode_chunk] if vectors is not None else
                 torch.as_tensor(data[s:s + encode_chunk], device=dev))
        bins_c, _, packed_c = DB.chunk_encoder(cfg, tree, chunk,
                                               DB._offset(s, dev), pair_occ)
        bins_l.append(bins_c)
        packed_l.append(packed_c)
    prefix, counts, prefix2, payload = DB._assemble_device(
        cfg, torch.cat(bins_l), torch.cat(packed_l))
    return DB.PQTDatabase(prefix=prefix, counts=counts, payload=payload,
                          pair_occ=pair_occ, vectors=vectors,
                          prefix2=prefix2)


def serial_encode_host(torch, cfg, tree, data, id_offset, encode_chunk,
                       pair_occ):
    """A frozen copy of models/db.py `_encode_host` before it went through
    the build's ring: each chunk up in one pageable copy, encoded, its
    bins and payload rows copied down."""
    from pqt_tpu_torch.models import db as DB
    dev = tree.cb1.device
    n = data.shape[0]
    bins = np.empty((n,), np.int32)
    packed = np.empty((n, DB.payload_width(cfg)), np.int32)
    for s in range(0, n, encode_chunk):
        chunk = torch.as_tensor(data[s:s + encode_chunk], device=dev)
        bins_c, _, packed_c = DB.chunk_encoder(
            cfg, tree, chunk, DB._offset(id_offset + s, dev), pair_occ)
        bins[s:s + encode_chunk] = bins_c.cpu().numpy()
        packed[s:s + encode_chunk] = packed_c.cpu().numpy()
    return bins, packed


@contextlib.contextmanager
def serial_host_encode(torch):
    """ChunkedDBBuilder and encode_chunk_to_file through
    `serial_encode_host`, their body before the ring."""
    from pqt_tpu_torch.models import db as DB
    staged = DB._encode_host
    DB._encode_host = functools.partial(serial_encode_host, torch)
    try:
        yield
    finally:
        DB._encode_host = staged


def serial_multi_build(torch, cfg, tree, data, group_parts, keep_vectors,
                       encode_chunk=ENCODE_CHUNK):
    """A frozen copy of models/multidb.py `build_multi_database`'s body
    before the build's ring: every row up first in one pageable copy
    (without keep_vectors, each chunk in one), the chunk encoder over the
    chunks, then the groups' assembly."""
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.models import multidb as M
    dev = tree.cb1.device
    vectors = torch.as_tensor(data, device=dev) if keep_vectors else None
    codes_l, packed_l = [], []
    for s in range(0, data.shape[0], encode_chunk):
        chunk = (vectors[s:s + encode_chunk] if vectors is not None else
                 torch.as_tensor(data[s:s + encode_chunk], device=dev))
        _, pc, rows = DB.chunk_encoder(cfg, tree, chunk, DB._offset(s, dev))
        codes_l.append(pc)
        packed_l.append(rows)
    dbs, pair_occ = M.assemble_multi_database(
        cfg, torch.cat(codes_l), torch.cat(packed_l), group_parts, None, dev)
    return M.MultiDatabase(databases=dbs, vectors=vectors, pair_occ=pair_occ)


def same_multi(torch, a, b):
    """Whether two multi-databases hold equal tensors in every leaf."""
    return (len(a.databases) == len(b.databases)
            and same_leaves(torch, a, b, ("vectors", "pair_occ"))
            and all(same_leaves(torch, x, y, DB_LEAVES)
                    for x, y in zip(a.databases, b.databases)))


def staged_entry_checks(torch, P, label, cfg, tree, data):
    """The other entries that stage host rows through the build's ring
    (models/db.py `_encode_rows`) against frozen copies of their bodies
    before it: ChunkedDBBuilder (two add_chunk calls, split on a chunk
    boundary) and its database, encode_chunk_to_file (two files) and
    their merge, against the same through `serial_encode_host` and
    against `serial_build`; build_multi_database (group_parts 2) against
    `serial_multi_build`; with keep_vectors and without, every leaf and
    every file equal to the bit, every chunk counted as staged.  Then the
    median seconds of UPLOAD_REPS warm calls a side, in alternation, of
    the host encode (`_encode_host` against `serial_encode_host`, one
    occupancy map) and of the multi-DB build, not claimed."""
    from pqt_tpu_torch.models import db as DB
    card = card_line()
    n = data.shape[0]
    chunks = -(-n // ENCODE_CHUNK)
    half = (chunks // 2) * ENCODE_CHUNK
    parts = ((0, data[:half]), (half, data[half:]))
    out, ok = {}, True
    with tempfile.TemporaryDirectory(prefix="pqt_staged_") as workdir:
        for keep in (True, False):
            res = {}

            def builder():
                b = P.ChunkedDBBuilder(cfg, tree, keep_vectors=keep,
                                       encode_chunk=ENCODE_CHUNK,
                                       device="cuda")
                for _, rows in parts:
                    b.add_chunk(rows)
                return b.finalize()

            def files(tag):
                paths = [os.path.join(workdir, f"{tag}{i}.npz")
                         for i in range(len(parts))]
                for path, (s, rows) in zip(paths, parts):
                    P.encode_chunk_to_file(cfg, tree, rows, s, path,
                                           encode_chunk=ENCODE_CHUNK,
                                           keep_vectors=keep, device="cuda")
                return paths

            before = DB.build_database.chunks_staged
            staged_db, staged_files = builder(), files("staged")
            mdb = P.build_multi_database(cfg, tree, data, 2, ENCODE_CHUNK,
                                         keep_vectors=keep, device="cuda")
            res["staged_chunks"] = DB.build_database.chunks_staged - before
            with serial_host_encode(torch):
                serial_db, serial_files = builder(), files("serial")
            res["builder_equal"] = same_leaves(torch, staged_db, serial_db,
                                               DB_LEAVES)
            del staged_db, serial_db
            res["files_equal"] = all(same_npz(a, b) for a, b in
                                     zip(staged_files, serial_files))
            # the merged files against the in-memory build's serial body
            merged = P.merge_chunk_files(cfg, tree, staged_files,
                                         device="cuda")
            one = serial_build(torch, cfg, tree, data, False)
            res["merge_equal"] = same_leaves(torch, merged, one, DB_LEAVES)
            del merged, one
            res["multi_equal"] = same_multi(
                torch, mdb, serial_multi_build(torch, cfg, tree, data, 2,
                                               keep))
            del mdb
            for path in staged_files + serial_files:
                os.remove(path)
            ok = ok and res["staged_chunks"] == 3 * chunks and all(
                res[k] for k in ("builder_equal", "files_equal",
                                 "merge_equal", "multi_equal"))
            out[f"keep_vectors={keep}"] = res
            print(f"{label} staged entries, keep_vectors={keep}: "
                  f"{res['staged_chunks']} of {3 * chunks} chunks staged; "
                  "ChunkedDBBuilder "
                  f"{'equal' if res['builder_equal'] else 'DIFFERS'}, "
                  "encode_chunk_to_file's files "
                  f"{'equal' if res['files_equal'] else 'DIFFER'} to their "
                  "serial body's, their merge "
                  f"{'equal' if res['merge_equal'] else 'DIFFERS'} to "
                  "serial_build's, build_multi_database "
                  f"{'equal' if res['multi_equal'] else 'DIFFERS'} to "
                  f"serial_multi_build's, to the bit [{card}]", flush=True)
    occ = torch.zeros((cfg.p // 2, cfg.part_radix ** 2), dtype=torch.uint8,
                      device="cuda")
    sides = {"host encode": (
        lambda: DB._encode_host(cfg, tree, data, 0, ENCODE_CHUNK, occ),
        lambda: serial_encode_host(torch, cfg, tree, data, 0, ENCODE_CHUNK,
                                   occ)),
             "multi-DB build": (
        lambda: P.build_multi_database(cfg, tree, data, 2, ENCODE_CHUNK,
                                       device="cuda"),
        lambda: serial_multi_build(torch, cfg, tree, data, 2, False))}
    for name, (staged, serial) in sides.items():
        staged(), serial()
        seconds = {"staged": [], "serial": []}
        for _ in range(UPLOAD_REPS):
            seconds["staged"].append(timed(torch, staged)[1])
            seconds["serial"].append(timed(torch, serial)[1])
        med = {k: float(np.median(v)) for k, v in seconds.items()}
        out[name] = seconds
        print(f"{label} {name} of {n} rows, seconds, median of {UPLOAD_REPS}"
              f" warm: staged {med['staged']:.4f}, serial {med['serial']:.4f}"
              f" ({n / med['staged']:.0f} against {n / med['serial']:.0f} "
              f"rows/s; not claimed) [{card}]", flush=True)
    clear_build_graphs()
    if not ok:
        raise SmokeFailure(f"{label}: a staged entry failed its check: "
                           f"{out}")
    return out


def covered_share(spans, cover):
    """The share of the summed lengths of `spans` ((start, end) pairs)
    that the union of `cover` overlaps."""
    merged = []
    for s, e in sorted(cover):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ends = [e for _, e in merged]
    total = covered = 0.0
    for s, e in spans:
        total += e - s
        for cs, ce in merged[bisect.bisect_right(ends, s):]:
            if cs >= e:
                break
            covered += min(e, ce) - max(s, cs)
    return covered / total if total > 0 else None


def profiled_upload(torch, P, cfg, tree, data):
    """One staged build (keep_vectors, graphs warm) under the profiler:
    its pageable and pinned host-to-device copies, the share of the
    pinned copies' time that kernels (no marks or pads) overlap, the
    chunks it staged, and its `pqt.build.stage` (host us a thousand rows)
    and `pqt.build.wait` spans."""
    from torch.profiler import ProfilerActivity, profile
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.utils import tracing
    before = DB.build_database.chunks_staged
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_trace(torch)
        db = P.build_database(cfg, tree, data, keep_vectors=True,
                              device="cuda")
        torch.cuda.synchronize()
    counted = DB.build_database.chunks_staged - before
    del db
    dev = _device_records(torch, prof)
    htod = [d for d in dev if d[0].startswith("Memcpy HtoD")]
    pinned = [(s, e) for name, s, e in htod if "Pinned" in name]
    kernels = [(s, e) for name, s, e in dev
               if not name.startswith(("Memcpy", "Memset"))
               and PAD_KERNEL not in name and tracing.MARK_KERNEL not in name]
    spans = {"pqt.build.stage": [0, 0.0], "pqt.build.wait": [0, 0.0]}
    for e in prof.events():
        if e.name in spans and \
                e.device_type != torch.autograd.DeviceType.CUDA:
            spans[e.name][0] += 1
            spans[e.name][1] += e.time_range.end - e.time_range.start
    return {"pageable_htod": sum("Pageable" in d[0] for d in htod),
            "pinned_htod": len(pinned),
            "pinned_htod_us": sum(e - s for s, e in pinned),
            "overlap_share": covered_share(pinned, kernels),
            "staged_chunks": counted,
            "stage_spans": spans["pqt.build.stage"][0],
            "stage_us_per_krow": spans["pqt.build.stage"][1] / (
                data.shape[0] / 1e3),
            "wait_spans": spans["pqt.build.wait"][0],
            "wait_us": spans["pqt.build.wait"][1]}


def upload_overlap_checks(torch, P, label, cfg, tree, data, profiled=False,
                          other_entries=False):
    """build_database's chunked upload (models/db.py `_row_chunks`) on the
    card against `serial_build`, the body before it: with keep_vectors and
    without, every leaf (pair_occ included) equal to the bit, every chunk
    counted as staged, and the median seconds of UPLOAD_REPS builds of
    each, warm and in alternation.  With `profiled`, `profiled_upload`:
    no pageable copy, and one pinned copy and one fill a chunk.  With
    `other_entries`, `staged_entry_checks`: the out-of-core and multi-DB
    encodes through the same ring.  Prints all beside the card's name and
    power limit."""
    from pqt_tpu_torch.models import db as DB
    card = card_line()
    n = data.shape[0]
    chunks = -(-n // ENCODE_CHUNK)
    out = {"rows": n, "chunks": chunks}
    ok = True
    for keep in (True, False):
        def staged_build():
            return P.build_database(cfg, tree, data, keep_vectors=keep,
                                    device="cuda")

        before = DB.build_database.chunks_staged
        staged = staged_build()
        counted = DB.build_database.chunks_staged - before
        serial = serial_build(torch, cfg, tree, data, keep)
        equal = same_leaves(torch, staged, serial, DB_LEAVES)
        del staged, serial
        seconds = {"staged": [], "serial": []}
        for _ in range(UPLOAD_REPS):
            seconds["staged"].append(timed(torch, staged_build)[1])
            seconds["serial"].append(timed(torch, lambda: serial_build(
                torch, cfg, tree, data, keep))[1])
        med = {k: float(np.median(v)) for k, v in seconds.items()}
        ok = ok and equal and counted == chunks
        out[f"keep_vectors={keep}"] = {"equal": equal, "staged_chunks":
                                       counted, "seconds": seconds}
        print(f"{label} upload overlap, keep_vectors={keep}: {n} rows in "
              f"{chunks} chunks, {counted} staged; build seconds, median of "
              f"{UPLOAD_REPS} warm: staged {med['staged']:.4f}, serial "
              f"(upload first) {med['serial']:.4f} ({n / med['staged']:.0f}"
              f" against {n / med['serial']:.0f} rows/s); every leaf, "
              f"pair_occ included, {'equal' if equal else 'DIFFERS'} to the "
              f"bit [{card}]", flush=True)
    if profiled:
        p = out["profiled"] = profiled_upload(torch, P, cfg, tree, data)
        share = p["overlap_share"]
        print(f"{label} upload overlap, one profiled staged build "
              f"(keep_vectors): {p['pageable_htod']} pageable and "
              f"{p['pinned_htod']} pinned host-to-device copies "
              f"({p['pinned_htod_us']:.1f} us), "
              f"{share if share is None else round(100 * share, 2)}% of "
              f"the pinned copies' time overlapped by kernels, "
              f"{p['staged_chunks']} of {chunks} chunks staged; "
              f"{p['stage_spans']} fills ({p['stage_us_per_krow']:.3f} host "
              f"us a thousand rows, profiled), {p['wait_spans']} waits for "
              f"a slot ({p['wait_us']:.1f} us) [{card}]", flush=True)
        ok = ok and not p["pageable_htod"] and chunks == p["staged_chunks"] \
            == p["pinned_htod"] == p["stage_spans"]
    if not ok:
        raise SmokeFailure(f"{label}: the chunked upload failed its check: "
                           f"{out}")
    if other_entries:
        out["other_entries"] = staged_entry_checks(torch, P, label, cfg,
                                                   tree, data)
    return out


def same_output(torch, a, b):
    """Whether two outputs of one entry point are equal to the bit: a
    QueryResult's ids, distances and n_candidates, a candidate set, or one
    tensor."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def trace_counts(torch, fn, x, attempts=4):
    """One call of fn(x) under the profiler: (its hand-written kernels
    counted by wrapper from their names, TRACE_KERNELS; the wrappers'
    launch counters over the same call; the hand-written kernels by
    name), from the kernel records of the session's chrome trace.  The
    call follows TRACE_PAD throwaway kernels in the session (see there).
    A session loses a prefix of its kernel records (one pad record in
    most sessions; in one run of PR 14 all the pads and the call's first
    kernels): one whose records hold none of the pads may have lost the
    call's, and is repeated, after a throwaway one, up to `attempts`
    times."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    for _ in range(attempts):
        reset_launches(torch)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad_trace(torch)
            fn(x)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
            with open(os.path.join(d, "trace.json")) as f:
                names = [e["name"] for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "kernel"]
        if any(PAD_KERNEL in name for name in names):
            break
        print(f"a profiler session kept none of its {TRACE_PAD} pad records "
              f"({len(names)} kernel records): repeated", flush=True)
        _profiled_us(torch, lambda: torch.ones(8, device="cuda") + 1, 1)
    else:
        raise SmokeFailure("every profiler session lost its pad records")
    counted, by_name = dict.fromkeys(TRACE_KERNELS, 0), {}
    for name in names:
        if re.search(MERGE_EXTRA, name):
            continue
        wrapper = next((w for w, firsts in TRACE_KERNELS.items()
                        if any(f in name for f in firsts)), None)
        if wrapper is not None:
            counted[wrapper] += 1
            by_name[name[:160]] = by_name.get(name[:160], 0) + 1
    return counted, {c.__name__: c.launches for c in counters()}, by_name


def graph_checks(torch, label, modes, eager, out, eager_out, qd, batch,
                 partner, before, lat, eager_lat):
    """Hold a path's replays to its eager bodies: every result of the
    window equal to the bit; one batch a mode replayed ALTERNATIONS times in
    alternation with the path's other graphs and `partner`'s, equal every
    time; the hand-written kernels of one replay's trace equal to the
    launch counts its capture recorded.  Prints the graphs' capture
    seconds and memory, and both servings with one profiled batch each."""
    entries = graph_entries()
    # a path may capture nothing: a database loaded again where a freed one
    # of the same shapes lay has its keys, so it replays that one's graphs
    new = [e for e in entries if id(e) not in before]
    held = sum(e.bytes for e in new) / 2 ** 20
    print(f"graphs of the {label}: {len(new)} captured (stages "
          f"{json.dumps([len(e.stages) for e in new])}), capture seconds "
          f"{json.dumps([round(e.capture_s, 4) for e in new])}, "
          f"{held:.1f} MiB held; the cache holds "
          f"{sum(e.bytes for e in entries) / 2 ** 20:.1f} MiB in all",
          flush=True)
    for mode in modes:
        if len(out[mode]) != len(eager_out[mode]) or not all(
                same_output(torch, a, b)
                for a, b in zip(out[mode], eager_out[mode])):
            raise SmokeFailure(f"{label} {mode}: a replayed result differs "
                               "from the eager body's")
    print(f"{label}: every replayed result equals the eager body's to the "
          f"bit over all {qd.shape[0]} queries ({', '.join(modes)})",
          flush=True)
    x = qd[:batch]
    runs = [(m, fn, x, out[m][0]) for m, fn in modes.items()]
    runs += [partner] if partner else []
    if len(runs) < 2:
        raise SmokeFailure(f"{label}: no other graph to alternate with")
    for _ in range(ALTERNATIONS):
        for name, fn, xb, ref in runs:
            if not same_output(torch, fn(xb), ref):
                raise SmokeFailure(f"{label}: a replay of {name} differs "
                                   "from its first in alternation")
    print(f"{label}: {ALTERNATIONS} alternating replays of one batch of "
          f"each of {', '.join(r[0] for r in runs)}: equal every time",
          flush=True)
    profiles, traced = {}, {}
    for m, fn in modes.items():
        replays = sum(e.replays for e in graph_entries())
        counted, recorded, by_name = trace_counts(torch, fn, x)
        if sum(e.replays for e in graph_entries()) < replays + 2:
            raise SmokeFailure(f"{label} {m}: not served by a replay")
        if counted != recorded:
            raise SmokeFailure(f"{label} {m}: the kernels of one replay's "
                               f"trace {counted} differ from the launch "
                               f"counts its capture recorded {recorded}; "
                               f"by name {json.dumps(by_name)}")
        traced[m] = counted
        profiles[m] = {"replay": profile_batch(torch, fn, x),
                       "eager": profile_batch(torch, eager[m], x)}
        r, e = lat[m], eager_lat[m]
        idle = {k: profiles[m][k].get("idle_share") for k in profiles[m]}
        print(f"{m:12s} replayed QPS {r['qps']:.0f} p50 {r['p50_ms']:.3f} "
              f"p90 {r['p90_ms']:.3f} max {r['max_ms']:.3f} ms idle "
              f"{idle['replay']}  |  eager QPS {e['qps']:.0f} p50 "
              f"{e['p50_ms']:.3f} p90 {e['p90_ms']:.3f} max "
              f"{e['max_ms']:.3f} ms idle {idle['eager']}", flush=True)
        for k, pr in profiles[m].items():
            print(f"profile {label} {m} {k}: " + json.dumps(pr), flush=True)
    print(f"{label}: the hand-written kernels of one replay's trace equal "
          f"the launch counts its capture recorded: {json.dumps(traced)}",
          flush=True)
    return {"profiles": profiles, "trace_kernels": traced,
            "graphs": {"captured": len(new),
                       "stages": [len(e.stages) for e in new],
                       "capture_s": [e.capture_s for e in new],
                       "mib": held}}


STAGE_MARK_REPS = 3


def _device_records(torch, prof) -> list:
    """(name, start_us, end_us) of a session's device events, in order."""
    return sorted(((e.name, float(e.time_range.start),
                    float(e.time_range.end)) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda d: d[1])


def stage_mark_checks(torch, label, fn, x, graphs, kind):
    """The stage marks (pqt_tpu_torch/utils/tracing.py) of the graph that
    serves fn(x), an entry of `graphs`, on the card: with the profiler off
    every mark node reads disabled (cudaGraphNodeGetEnabled) and an eager
    call launches no mark; while a session records, each of
    STAGE_MARK_REPS replays shows the `kind`'s marks once, in the order of
    STAGES, and no device event bears a `pqt.` name; once it stops, the
    next replay's nodes read disabled again; every output, marks on or
    off, equal to the bit.  Prints and returns the marks' summed device
    time a replay, and what a session drops first: a session that starts
    with the replays (no pads) tells whether its lost records are marks."""
    from torch.profiler import ProfilerActivity, profile
    from pqt_tpu_torch.utils import graphs as G
    from pqt_tpu_torch.utils import tracing
    want = [st for st in tracing.STAGES if st.startswith(kind + ".")]
    before = {id(e): e.replays for e in graphs.values()}
    off = fn(x)
    torch.cuda.synchronize()
    served = [e for e in graphs.values() if e.replays > before.get(id(e), 0)]
    if len(served) != 1:
        raise SmokeFailure(f"{label}: {len(served)} graphs replayed, not 1")
    marks = served[0].marks

    def disabled():
        return not any(tracing.node_enabled(ex, node)
                       for _, ex, node, _ in marks.nodes)

    nodes = sorted(tracing.STAGES[i] for *_, i in marks.nodes)
    off_disabled = disabled()
    launched = []
    launch = tracing._launch
    tracing._launch = lambda i, d: (launched.append(i), launch(i, d))[1]
    try:
        with G.eager():
            eager_out = fn(x)
        torch.cuda.synchronize()
    finally:
        tracing._launch = launch
    sessions, outs = {}, [eager_out]
    for pads in (0, TRACE_PAD):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if pads:
                pad_trace(torch)
            outs += [fn(x) for _ in range(STAGE_MARK_REPS)]
            torch.cuda.synchronize()
        dev = _device_records(torch, prof)
        seen = [(tracing.STAGES[int(n.split("<", 1)[1].split(">", 1)[0])],
                 e - s) for n, s, e in dev if tracing.MARK_KERNEL in n]
        sessions[pads] = {
            "pads_kept": sum(PAD_KERNEL in d[0] for d in dev),
            "marks_kept": len(seen), "marks_launched":
                len(want) * STAGE_MARK_REPS,
            "first_record": dev[0][0][:80] if dev else None,
            "marks": [m for m, _ in seen], "mark_us": [d for _, d in seen],
            "pqt_device_events": sorted({d[0] for d in dev
                                         if d[0].startswith("pqt.")})}
    after = fn(x)
    torch.cuda.synchronize()
    after_disabled = disabled()
    outs.append(after)
    equal = all(same_output(torch, o, off) for o in outs)
    padded = sessions[TRACE_PAD]
    in_order = padded["marks"] == want * STAGE_MARK_REPS
    mark_us = sum(padded["mark_us"]) / STAGE_MARK_REPS
    bare = sessions[0]
    lost = bare["marks_launched"] - bare["marks_kept"]
    print(f"{label}: mark nodes {nodes}; profiler off: every node "
          f"{'disabled' if off_disabled else 'NOT disabled'}, an eager call "
          f"launched {len(launched)} marks; profiled: {STAGE_MARK_REPS} "
          f"replays show their marks {'once each, in order' if in_order else 'OUT OF ORDER: ' + str(padded['marks'])}, "
          f"{mark_us:.3f} us of marks a replay, device events named pqt.: "
          f"{padded['pqt_device_events'] + bare['pqt_device_events']}; "
          f"after the session every node "
          f"{'disabled' if after_disabled else 'NOT disabled'}; outputs "
          f"{'equal' if equal else 'DIFFER'} to the bit, marks on and off; "
          f"a session that starts with the replays kept {bare['marks_kept']} "
          f"of {bare['marks_launched']} marks (its first record "
          f"{bare['first_record']!r}), one that starts with {TRACE_PAD} pads "
          f"kept {padded['pads_kept']} pads", flush=True)
    if nodes != sorted(want) or not (off_disabled and after_disabled) \
            or launched or not in_order or not equal \
            or padded["pqt_device_events"] or bare["pqt_device_events"]:
        raise SmokeFailure(f"{label}: the stage marks failed their check")
    return {"nodes": nodes, "mark_us_per_replay": mark_us,
            "dropped_marks_unpadded": lost, "sessions": sessions}


def graph_summary(path):
    """A served path's numbers of its replays against its eager bodies."""
    return {k: path[k] for k in ("eager_serving", "profiles",
                                 "trace_kernels", "graphs")}


def partner_of(path, mode, qd, batch=BATCH):
    """One mode of a served path, for other paths to alternate with."""
    return (mode, path["modes"][mode], qd[:batch],
            path["outputs"][mode][0])


def query_paths(torch, P):
    # the pair path's cfg leaves the pair filter off, as bench.py does
    cfg = P.SIFT1M_CONFIG.replace(
        kmeans_iters=8, train_subsample=100_000, hash_size=1 << 20,
        max_bins=512, max_candidates=1024, pair_top_m=128, enum_width=512,
        pair_filter=False)
    parts_cfg = cfg.replace(pipeline="parts", pair_filter=True)
    slabs_cfg = parts_cfg.replace(gather_mode="slabs", slab_size=32)
    wide_cfg = cfg.replace(payload_compact=False)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    data, subcenters = make_sift_like(N_DB, cfg.dim, rng)
    queries = make_queries(N_QUERIES, subcenters, rng)
    print(f"fixture: {N_DB} x {cfg.dim} uint8, {N_QUERIES} queries "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # phase 4: the pair path, train and build included
    from pqt_tpu_torch.models import kmeans as KM
    reset_launches(torch)
    steps = KM.lloyd_steps["run"]
    t0 = time.perf_counter()
    tree = P.train_tree(cfg, data[:N_TRAIN], device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_steps = KM.lloyd_steps["run"] - steps
    t0 = time.perf_counter()
    # the build with the pair filter on also makes pair_occ; every other
    # array equals the build without it
    db = P.build_database(cfg.replace(pair_filter=True), tree, data,
                          keep_vectors=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"train_s {train_s:.2f}  build_s {build_s:.2f}  (non-empty bins "
          f"{int((db.counts > 0).sum())}, pair_occ "
          f"{tuple(db.pair_occ.shape)})", flush=True)
    qd = torch.as_tensor(queries, device="cuda")
    all_modes = ("exact", "line", "refine", "candidates")

    def modes_of(c, d, names):
        return dict(modes=query_modes(P, c, tree, d, names),
                    eager=query_modes(P, c, tree, d, names, eager=True))

    built = read_launches("pair path's train and build", BUILD_KERNELS)
    train_build = train_build_phase(
        torch, P, cfg, data, tree, db,
        dict(train_s=train_s, build_s=build_s, train_steps=train_steps))
    train_build["upload_overlap"] = upload_overlap_checks(
        torch, P, "SIFT1M", cfg.replace(pair_filter=True), tree, data,
        other_entries=True)
    train_build["part_codes"] = part_codes_checks(torch, P, "SIFT1M", cfg,
                                                  tree, data)
    clear_build_graphs()
    paths = {"pair": serve_path(
        torch, "pair path", qd=qd, required=PAIR_KERNELS + EXACT_KERNELS,
        cfg=cfg, db=db, reference=(ROUND5, "round 5"),
        **modes_of(cfg, db, all_modes))}
    stage_marks = {"sift1m_exact": stage_mark_checks(
        torch, "SIFT1M exact query", paths["pair"]["modes"]["exact"],
        qd[:BATCH], P.query_knn.graphs, "query")}
    # the pair path's reference counts include its train and build
    paths["pair"]["launches"] = {k: n + built[k] for k, n in
                                 paths["pair"]["launches"].items()}
    print("launches on the pair path with its train and build: "
          + json.dumps(paths["pair"]["launches"]), flush=True)
    partner = partner_of(paths["pair"], "line", qd)

    # phase 5: the parts path, then its slab-gather variant
    paths["parts"] = serve_path(
        torch, "parts path", qd=qd, required=PARTS_KERNELS + EXACT_KERNELS,
        partner=partner, cfg=parts_cfg, db=db,
        reference=(JAX_CPU_PARTS, "JAX on the CPU"),
        **modes_of(parts_cfg, db, all_modes))
    paths["parts_slabs"] = serve_path(
        torch, "parts path with slab gathers", qd=qd,
        required=PARTS_KERNELS + EXACT_KERNELS, partner=partner,
        cfg=slabs_cfg, db=db, reference=(JAX_CPU_SLABS, "JAX on the CPU"),
        **modes_of(slabs_cfg, db, ("exact", "line", "candidates")))

    # phase 6: the BIG two-stage path, line and perfect, on the same
    # database; then the pair path's line mode over the wide payload
    for name in ("big_line", "big_perfect"):
        paths[name] = serve_path(
            torch, f"BIG path ({name[4:]})", qd=qd,
            required=BIG_KERNELS + (EXACT_KERNELS if name == "big_perfect"
                                    else ()),
            partner=partner, cfg=cfg, db=db,
            reference=(JAX_CPU_BIG, "JAX on the CPU"),
            **modes_of(cfg, db, (name,)))
    wide_db = P.build_database(wide_cfg, tree, data, device="cuda")
    paths["pair_wide"] = serve_path(
        torch, "pair path over the wide payload", qd=qd,
        required=PAIR_KERNELS, need=("rerank_fused:wide",), partner=partner,
        cfg=wide_cfg, db=wide_db, reference=({}, "compact payload"),
        **modes_of(wide_cfg, wide_db, ("line",)))

    gt = brute_force_phase(torch, data, qd)
    failed, changed = [], []
    summary = {"train_s": train_s, "build_s": build_s, "paths": {},
               "train_build": train_build, "stage_marks": stage_marks}
    for label, path in paths.items():
        c = path["cfg"]
        metrics = path_recall(torch, label, path["outputs"], gt)
        thresholds = THRESHOLDS
        if label == "pair_wide":
            ref = paths["pair"]["recall"]["line_top10_intersection"]
            path["reference"] = ({"line_top10_intersection": ref},
                                 "compact payload")
            thresholds = {"line_top10_intersection": round(ref - 0.01, 4)}
        failed += report(label, metrics, path["serving"], *path["reference"],
                         thresholds)
        changed += differs_from_reference(label, path["launches"], metrics)
        path["recall"] = metrics
        summary["paths"][label] = {
            "pipeline": c.pipeline, "pair_filter": c.pair_filter,
            "gather_mode": c.gather_mode,
            "payload_compact": c.payload_compact,
            "launches": path["launches"],
            "serving": path["serving"], "recall": metrics,
            **graph_summary(path)}
    if failed:
        raise SmokeFailure(f"recall below threshold: {failed}")
    if changed:
        raise SmokeFailure(f"launch counts or recall differ from the "
                           f"reference run's: {changed}")
    return summary, dict(cfg=cfg, tree=tree, data=data, queries=queries,
                         qd=qd, gt=gt, db=db, partner=partner)


def brute_force_phase(torch, data, qd):
    """The exact neighbours of the queries (the float64 oracle), and
    `brute_force_knn_fast` held to the oracle's K + 1 (to see ties at the
    edge): its ids equal the oracle's wherever the distances are untied
    with their neighbours in the ranking (integer-valued vectors, so its
    float32 distances are exact).  Returns the oracle's top-K ids (numpy)."""
    from pqt_tpu_torch.ops.distance import (brute_force_knn,
                                            brute_force_knn_fast)
    db = torch.as_tensor(data, device="cuda")
    gt_k = brute_force_knn(qd, db, K)[1].cpu().numpy()
    d64, gt = brute_force_knn(qd, db, K + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast_d, fast_i = brute_force_knn_fast(qd, db, K)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = device_ms(torch, lambda: brute_force_knn_fast(qd, db, K),
                        reps=3, warmup=1)
    untied = (d64[:, :K] != d64[:, 1:]) & torch.cat(
        [torch.ones_like(d64[:, :1], dtype=torch.bool),
         d64[:, 1:K] != d64[:, :K - 1]], dim=1)
    bad = int((fast_i.to(torch.int64) != gt[:, :K])[untied].sum())
    err = float((fast_d.to(torch.float64) - d64[:, :K]).abs().max())
    print(f"brute_force_knn_fast ({qd.shape[0]} queries over {db.shape[0]} "
          f"vectors, k {K}): {wall_ms:.2f} ms wall (first call), "
          f"{busy_ms:.3f} ms device; ids equal the float64 oracle's at "
          f"{int(untied.sum())} untied ranks, {bad} differ; max distance "
          f"error {err}", flush=True)
    if bad:
        raise SmokeFailure(f"brute_force_knn_fast: {bad} ids at untied ranks "
                           "differ from the float64 oracle's")
    del db, d64, gt, fast_d, fast_i
    torch.cuda.empty_cache()
    return gt_k


def host_rss_gib():
    """(current, peak) resident host memory of this process, GiB."""
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    with open("/proc/self/status") as f:
        cur = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS:")) / 2 ** 20
    return cur, peak


def meminfo_line():
    with open("/proc/meminfo") as f:
        info = dict(line.split(":", 1) for line in f)
    return ", ".join(f"{k} {info[k].strip()}" for k in
                     ("MemTotal", "MemAvailable") if k in info)


def sift1b_fixture(torch, n, seed=0):
    """rehearsal_50m.py's cluster model at n points (n_coarse = max(1024,
    n // 320) coarse clusters of 16 subclusters each, so the points spread
    over SIFT-like bins at any n), drawn on the card: (subcenters on the
    card, a function that draws `size` uint8 points on the card)."""
    rng = np.random.default_rng(seed)
    _, sub = make_sift_like(1, 128, rng, n_coarse=max(1024, n // 320),
                            subs_per_coarse=16)
    sub = torch.as_tensor(sub, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(size):
        which = torch.randint(0, sub.shape[0], (size,), generator=gen,
                              device="cuda")
        x = sub[which] + 5.0 * torch.randn((size, sub.shape[1]),
                                           generator=gen, device="cuda")
        return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)

    return sub, draw


def sift1b_database(torch, P, workdir):
    """SIFT1B_CONFIG at full width over 10M vectors, built out of core:
    chunk files, host merge with the spill, sidecar save, load onto the
    card.  Returns a dict: cfg, tree, db, data (on the card), qd (the
    queries), paths (the chunk files), times, build_launches, nonempty,
    largest."""
    from pqt_tpu_torch.io import native

    cfg = P.SIFT1B_CONFIG.replace(kmeans_iters=8, train_subsample=100_000)
    print(f"-- sift1b: {N_1B} vectors of SIFT1B's 10^9, a cut forced by "
          "the smoke's run time; every width as SIFT1B_CONFIG (hash 2^29, "
          f"{cfg.max_bins} bins, {cfg.max_candidates} candidates, "
          f"pair_top_m {cfg.pair_top_m}, enum_width {cfg.enum_width}, "
          f"k1_query {cfg.k1_query}, lp {cfg.line_parts}); host "
          f"{meminfo_line()}", flush=True)
    if native.get_lib() is None:
        raise SmokeFailure("the native host runtime did not load: "
                           f"{native.load_error()}")
    times = {}
    t0 = time.perf_counter()
    _, draw = sift1b_fixture(torch, N_1B)
    data = torch.empty((N_1B, 128), dtype=torch.uint8, device="cuda")
    for s in range(0, N_1B, N_1B_CHUNK):
        data[s:s + N_1B_CHUNK] = draw(min(N_1B_CHUNK, N_1B - s))
    qd = draw(N_QUERIES).to(torch.float32)
    torch.cuda.synchronize()
    times["fixture_s"] = time.perf_counter() - t0

    reset_launches(torch)
    tree, times["train_s"], times["train_steps"] = trained(
        torch, P, cfg, data[:N_1B_TRAIN])
    paths = [os.path.join(workdir, f"chunk{i}.npz")
             for i in range(-(-N_1B // N_1B_CHUNK))]
    times["encode_s"], spans = encode_files(P, cfg, tree, data, paths)
    build_launches = read_launches("SIFT1B train and encode",
                                   BUILD_KERNELS)
    build = sift1b_build_checks(torch, P, cfg, tree, data, paths, workdir,
                                times, spans)
    host_rows = data[:N_OVERLAP].cpu().numpy()
    build["upload_overlap"] = upload_overlap_checks(
        torch, P, "SIFT1B", cfg, tree, host_rows, profiled=True)
    build["part_codes"] = part_codes_checks(torch, P, "SIFT1B", cfg, tree,
                                            host_rows)
    del host_rows
    clear_build_graphs()
    t0 = time.perf_counter()
    host_db = P.merge_chunk_files(cfg, tree, paths, keep_vectors=True,
                                  spill_path=os.path.join(workdir, "spill"),
                                  to_device=False)
    times["merge_s"] = time.perf_counter() - t0
    nonempty = int(np.count_nonzero(host_db.counts))
    largest = int(host_db.counts.max())
    t0 = time.perf_counter()
    base = os.path.join(workdir, "db")
    P.save_database(base, cfg, host_db, adopt_memmaps=True)
    times["save_s"] = time.perf_counter() - t0
    del host_db
    t0 = time.perf_counter()
    db = P.load_database(base, cfg, device="cuda")
    torch.cuda.synchronize()
    times["load_s"] = time.perf_counter() - t0
    if db.vectors is not None or db.vectors_csr is None:
        raise SmokeFailure("sift1b: the loaded database should hold "
                           "vectors_csr only")
    rss = host_rss_gib()
    print(f"sift1b: fixture {times['fixture_s']:.1f} s, train "
          f"{times['train_s']:.1f} s, encode {times['encode_s']:.1f} s, "
          f"merge {times['merge_s']:.1f} s, save {times['save_s']:.1f} s, "
          f"load {times['load_s']:.1f} s; non-empty bins {nonempty}, "
          f"largest bin {largest}; host RSS {rss[0]:.2f} GiB (peak "
          f"{rss[1]:.2f})", flush=True)
    return {"cfg": cfg, "tree": tree, "db": db, "data": data, "qd": qd,
            "paths": paths, "times": times, "build_launches": build_launches,
            "nonempty": nonempty, "largest": largest, "build": build}


def encode_file(P, cfg, tree, data, s, path):
    """The SIFT1B fixture's (on the card) N_1B_CHUNK rows from row s
    brought to the host and encoded into the chunk file `path`: (seconds,
    its two steps in seconds: "fixture_download", the copy to the host,
    and "encode_chunk_to_file", the rows' upload, encode and copy down
    and the file's save)."""
    t0 = time.perf_counter()
    rows = data[s:s + N_1B_CHUNK].cpu().numpy()
    t1 = time.perf_counter()
    P.encode_chunk_to_file(cfg, tree, rows, s, path, keep_vectors=True,
                           device="cuda")
    t2 = time.perf_counter()
    return t2 - t0, {"fixture_download": t1 - t0,
                     "encode_chunk_to_file": t2 - t1}


def add_spans(total, spans):
    for k, v in spans.items():
        total[k] = total.get(k, 0.0) + v


def encode_files(P, cfg, tree, data, paths):
    """encode_file over the whole fixture: (seconds, stages)."""
    seconds, spans = 0.0, {}
    for path, s in zip(paths, range(0, N_1B, N_1B_CHUNK)):
        t, got = encode_file(P, cfg, tree, data, s, path)
        seconds += t
        add_spans(spans, got)
    return seconds, spans


@contextlib.contextmanager
def plain_line_codes():
    """Kernel L's plain version in the place of its wrapper, for the eager
    bodies called inside: the build's line codes by the chain of passes
    they took before the kernel, the line tables' and the selection's (its
    launches are not counted)."""
    from pqt_tpu_torch.ops import linecodes as L
    from pqt_tpu_torch.ops.cuda import linecodes as lc
    wrapper = lc.line_codes
    lc.line_codes = L.line_codes_from_terms_plain
    try:
        yield
    finally:
        lc.line_codes = wrapper


@contextlib.contextmanager
def plain_part_codes():
    """Kernel P's plain version in the place of its wrapper, for the eager
    bodies called inside: the build's part codes by the chain of passes
    they took before the kernel (its launches are not counted)."""
    from pqt_tpu_torch.ops import distance as D
    from pqt_tpu_torch.ops.cuda import partcodes as pc
    wrapper = pc.part_codes
    pc.part_codes = D.part_codes_plain
    try:
        yield
    finally:
        pc.part_codes = wrapper


def tf32_state(torch):
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def bins_and_rows_by_id(torch, db):
    """(bin (n,) int64, payload row (n, width)) of each id of a built
    database, from its CSR layout."""
    n = db.payload.shape[0]
    pos = torch.arange(n, dtype=db.prefix.dtype, device=db.payload.device)
    bins = torch.searchsorted(db.prefix, pos, right=True) - 1
    ids = db.payload[:, 0].to(torch.int64)
    by_id = torch.empty(n, dtype=torch.int64, device=bins.device)
    by_id[ids] = bins
    rows = torch.empty_like(db.payload)
    rows[ids] = db.payload
    return by_id, rows


def part_codes_checks(torch, P, label, cfg, tree, data):
    """Kernel P on the card at `cfg`'s widths with a trained tree: one
    ENCODE_CHUNK-row chunk of `data` (host rows) through P and through its
    plain version, each code that differs a near-tie (the plain distances
    of the two picks within NEAR_TIE_REL) and at most PART_CODES_DIFFER of
    them, with P's and the plain version's device ms beside P's bound;
    then a build of all of `data` against the same build through the plain
    version (eager): every row's bin and payload row equal but where the
    row's part codes differ, and P launched once a chunk; the TF32 flags
    unchanged.  Prints all beside the card's name and power limit."""
    from pqt_tpu_torch.ops import distance as D
    from pqt_tpu_torch.ops.cuda import partcodes as pc
    from pqt_tpu_torch.utils import graphs as G
    card = card_line()
    flags = tf32_state(torch)
    flat = tree.cb2.reshape(cfg.p, cfg.c1 * cfg.c2, cfg.vl)
    n, p, k, vl = ENCODE_CHUNK, cfg.p, cfg.c1 * cfg.c2, cfg.vl

    def rows(s, e):
        return torch.as_tensor(data[s:e], device="cuda").to(torch.float32)

    x = rows(0, n)
    _, differ, near, gap = part_code_differences(torch, x, flat)
    args = D.part_norms(x, flat)
    b_ms, b_by = bound(n * p * vl * 4 + p * k * vl * 4 + p * k * 4
                       + n * p * 4 + n * p * 8, 2 * n * p * k * vl)
    out = {"chunk": [n, p, k, vl], "differ": differ, "gap": gap,
           "ms": device_ms(torch, lambda: pc.part_codes(*args)),
           "plain_ms": device_ms(torch, lambda: D.part_codes_plain(*args),
                                 reps=5),
           "bound_ms": b_ms, "bound_by": b_by}
    del x, args
    # the rows of the whole build whose part codes differ
    total, differ_rows = data.shape[0], []
    for s in range(0, total, ENCODE_CHUNK):
        a = D.part_norms(rows(s, s + ENCODE_CHUNK), flat)
        d = (pc.part_codes(*a) != D.part_codes_plain(*a)).any(dim=1)
        differ_rows.append(d.nonzero()[:, 0] + s)
    differ_rows = torch.cat(differ_rows)
    before = pc.part_codes.launches
    db = P.build_database(cfg, tree, data, encode_chunk=ENCODE_CHUNK,
                          device="cuda")
    launched = pc.part_codes.launches - before
    with plain_part_codes(), G.eager():
        plain = P.build_database(cfg, tree, data, encode_chunk=ENCODE_CHUNK,
                                 device="cuda")
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(db, f), getattr(plain, f))
               for f in ("prefix", "counts", "payload"))
    if same:
        outside = True
    else:
        keep = torch.ones(total, dtype=torch.bool, device="cuda")
        keep[differ_rows] = False
        mine, theirs = bins_and_rows_by_id(torch, db), \
            bins_and_rows_by_id(torch, plain)
        outside = all(torch.equal(a[keep], b[keep])
                      for a, b in zip(mine, theirs))
    del db, plain
    torch.cuda.empty_cache()
    chunks = -(-total // ENCODE_CHUNK)
    out.update(build_rows=total, build_rows_differ=int(differ_rows.numel()),
               build_equal=same, equal_outside=outside, launched=launched,
               chunks=chunks, tf32=[str(f) for f in tf32_state(torch)])
    verdict = ("equal to the bit" if same else
               "equal outside them" if outside else "DIFFER")
    print(f"{label} part codes: kernel P on a {n}-row chunk ({p} parts, "
          f"{k} centroids, vl {vl}) {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
          f"{differ} codes differ (largest gap of their plain distances "
          f"{gap:.3g}); a {total}-row build: {differ_rows.numel()} rows' "
          f"codes differ, bins and payload rows {verdict} against the "
          f"plain route's, P launched {launched} times in {chunks} chunks; "
          f"TF32 flags {tf32_state(torch)} [{card}]", flush=True)
    if (differ > PART_CODES_DIFFER * n * p or not near or not outside
            or launched != chunks or tf32_state(torch) != flags
            or flags[0]):
        raise SmokeFailure(f"{label}: kernel P failed its check: {out}")
    return out


def sift1b_build_checks(torch, P, cfg, tree, data, paths, workdir, times,
                        spans):
    """The SIFT1B train and encode again through their eager bodies: the
    tree and every chunk file (bins, payload rows, raw vectors, pair_occ)
    equal to the replayed ones to the bit; one 65536-row chunk's p50,
    replayed, eager and eager through kernel L's plain version (the route
    before the kernel), each with one profiled chunk, and the replayed
    chunk equal to the plain route's to the bit; rows a second, encode_s's
    two steps and the Lloyd steps, printed beside the card's
    name and power limit; the graphs' keys, then freed."""
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.utils import graphs as G
    card = card_line()
    out = {"graphs": build_graphs_report("the SIFT1B train and encode"),
           "replayed": {"train_s": times["train_s"],
                        "train_steps": times["train_steps"],
                        "encode_s": times["encode_s"], "spans": spans}}
    x = data[:ENCODE_CHUNK]
    # the chunk files' occupancy map: the files' graph serves the chunk
    occ = DB._file_pair_occ((cfg.p // 2, cfg.part_radix ** 2), x.device)
    offset = DB._offset(0, x.device)
    out["chunk"] = {}

    def plain(*args):
        with plain_line_codes():
            return DB.chunk_encoder.__wrapped__(*args)

    for name, fn in (("replayed", DB.chunk_encoder),
                     ("eager", DB.chunk_encoder.__wrapped__),
                     ("plain", plain)):
        def call(xb, fn=fn):
            return fn(cfg, tree, xb, offset, occ)
        out["chunk"][name] = {"p50_ms": p50_ms(torch, call, x),
                              "profile": profile_batch(torch, call, x)}
    # the replayed chunk against the same chunk through kernel L's plain
    # version: bins, part codes and payload rows equal to the bit
    plain_eq = same_output(torch, DB.chunk_encoder(cfg, tree, x, offset, occ),
                           plain(cfg, tree, x, offset, occ))
    print(f"sift1b: a replayed {ENCODE_CHUNK}-row chunk's bins, part codes "
          f"and payload rows {'equal' if plain_eq else 'DIFFER from'} "
          "those of the chunk encoded through line_codes_plain on the card"
          + (" to the bit" if plain_eq else ""), flush=True)
    out["stage_marks"] = {"sift1b_chunk_encoder": stage_mark_checks(
        torch, "SIFT1B chunk encoder",
        lambda xb: DB.chunk_encoder(cfg, tree, xb, offset, occ), x,
        DB.chunk_encoder.graphs, "encode")}
    with G.eager():
        etree, train_s, steps = trained(torch, P, cfg, data[:N_1B_TRAIN])
        tree_eq = same_leaves(torch, tree, etree, TREE_LEAVES)
        del etree
        eager_path = os.path.join(workdir, "eager_chunk.npz")
        files_eq, encode_s, espans = True, 0.0, {}
        for path, s in zip(paths, range(0, N_1B, N_1B_CHUNK)):
            seconds, got = encode_file(P, cfg, tree, data, s, eager_path)
            encode_s += seconds
            add_spans(espans, got)
            files_eq = files_eq and same_npz(path, eager_path)
            os.remove(eager_path)
    out["eager"] = {"train_s": train_s, "train_steps": steps,
                    "encode_s": encode_s, "spans": espans}
    for side in ("replayed", "eager"):
        o = out[side]
        o["rows_per_s"] = N_1B / o["encode_s"]
    r, e, c = out["replayed"], out["eager"], out["chunk"]
    idle = {k: (v["profile"].get("device_busy_ms"),
                v["profile"].get("idle_share")) for k, v in c.items()}
    print(f"sift1b train (kmeans_iters {cfg.kmeans_iters}): replayed "
          f"{r['train_s']:.4f} s ({r['train_steps']} Lloyd steps), eager "
          f"{e['train_s']:.4f} s ({e['train_steps']} steps); encode_s of "
          f"{N_1B} rows: replayed {r['encode_s']:.3f} s ({r['rows_per_s']:.0f}"
          f" rows/s: "
          f"{json.dumps({k: round(v, 4) for k, v in r['spans'].items()})}), "
          f"eager {e['encode_s']:.3f} s ({e['rows_per_s']:.0f} rows/s: "
          f"{json.dumps({k: round(v, 4) for k, v in e['spans'].items()})}); "
          f"a {ENCODE_CHUNK}-row chunk p50 replayed "
          f"{c['replayed']['p50_ms']:.3f} ms, eager {c['eager']['p50_ms']:.3f}"
          f" ms, eager through line_codes_plain {c['plain']['p50_ms']:.3f} ms"
          f" (device busy ms, idle share of one profiled chunk: replayed "
          f"{idle['replayed']}, eager {idle['eager']}, plain "
          f"{idle['plain']}); the trees "
          f"{'equal' if tree_eq else 'DIFFER'} and the {len(paths)} chunk "
          f"files {'equal' if files_eq else 'DIFFER'} to the bit [{card}]",
          flush=True)
    for k, v in c.items():
        print(f"profile sift1b chunk encode {k}: " + json.dumps(v["profile"]),
              flush=True)
    clear_build_graphs()
    if not (tree_eq and files_eq):
        raise SmokeFailure("sift1b: a replayed train or chunk file differs "
                           "from its eager body's")
    if not plain_eq:
        raise SmokeFailure("sift1b: a replayed chunk differs from the chunk "
                           "encoded through line_codes_plain")
    out.update(trees_equal=tree_eq, files_equal=files_eq,
               plain_route_equal=plain_eq)
    return out


def sift1b_phase(torch, P, workdir):
    """SIFT1B_CONFIG at full width over 10M vectors, out of core
    (sift1b_database); then exact and refine through vectors_csr, line,
    candidates, BIG line and BIG perfect at batch 64."""
    from pqt_tpu_torch.ops.distance import brute_force_knn

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    built = sift1b_database(torch, P, workdir)
    cfg, tree, db, data, qd, paths, times = (
        built[k] for k in ("cfg", "tree", "db", "data", "qd", "paths",
                           "times"))
    build_launches, build = built["build_launches"], built["build"]
    nonempty, largest = built["nonempty"], built["largest"]
    del built              # the database is freed before the sharded chain

    loaded_gib = torch.cuda.memory_allocated() / 2 ** 30
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    # BIG perfect re-ranks by id: the vectors by id, attached on the card
    by_id = db._replace(vectors=data)

    def modes_of(eager):
        modes = query_modes(P, cfg, tree, db, ("exact", "line", "refine",
                                               "candidates", "big_line"),
                            eager)
        modes.update(query_modes(P, cfg, tree, by_id, ("big_perfect",),
                                 eager))
        return modes

    modes = modes_of(False)
    path = serve_path(torch, "SIFT1B phase", modes, qd,
                      ALL_KERNELS + EXACT_KERNELS,
                      ("bitonic_topk:merge", "bitonic_topk:cluster"),
                      batch=BATCH_1B, eager=modes_of(True))
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    build["stage_marks"]["sift1b_exact"] = stage_mark_checks(
        torch, "SIFT1B exact query", path["modes"]["exact"], qd[:BATCH_1B],
        P.query_knn.graphs, "query")
    print(f"sift1b: device memory held after the load {loaded_gib:.2f} GiB "
          f"(tables, payload, vectors_csr, the data by id, the tree), "
          f"peak while serving {serve_peak:.2f} GiB", flush=True)
    _, gt = brute_force_knn(qd, data, K)
    metrics = path_recall(torch, "sift1b", path["outputs"], gt.cpu().numpy())
    # BIG line R@10 within 0.05 of the pair path's (the JAX package's own
    # rule, tests/test_query_big.py)
    floors = dict(SIFT1B_FLOORS, **{
        "big_line_R@10": round(metrics["line_R@10"] - 0.05, 4)})
    failed = report("sift1b", metrics, path["serving"],
                    {"big_line_R@10": metrics["line_R@10"]},
                    "reference (the pair path's line_R@10 for BIG line)",
                    floors)
    changed = (differs_from_reference("sift1b_build", build_launches)
               + differs_from_reference("sift1b", path["launches"], metrics))
    peak = max(load_peak, serve_peak,
               torch.cuda.max_memory_allocated() / 2 ** 30)
    # phase 8 at SIFT1B width: the single-device database freed, the same
    # chunk files served over N_SHARDS shards
    # the modes' closures hold the database, the graphs their pools
    del db, by_id, modes, data, path["modes"], path["outputs"]
    clear_graphs()
    torch.cuda.empty_cache()
    sharded, f, c = sift1b_sharded(torch, cfg, tree, paths, qd,
                                   gt.cpu().numpy(), metrics)
    failed, changed = failed + f, changed + c
    for chunk in paths:
        os.remove(chunk)
    peak = max(peak, sharded["peak_device_gib"])
    rss = host_rss_gib()
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"sift1b: {times['phase_s']:.1f} s in all, peak device memory "
          f"{peak:.2f} GiB (with the float64 oracle), host RSS "
          f"{rss[0]:.2f} GiB (peak {rss[1]:.2f})", flush=True)
    if failed:
        raise SmokeFailure(f"sift1b recall or check failed: {failed}")
    if changed:
        raise SmokeFailure(f"sift1b launch counts or recall differ from "
                           f"the reference run's: {changed}")
    return {"n": N_1B, "cut": "10M of SIFT1B's 10^9 (the smoke's run time)",
            "times": times, "nonempty_bins": nonempty, "largest_bin": largest,
            "peak_device_gib": peak, "loaded_device_gib": loaded_gib,
            "serving_peak_device_gib": serve_peak, "host_rss_gib": rss[0],
            "host_peak_rss_gib": rss[1], "build_launches": build_launches,
            "build": build,
            "launches": path["launches"], "serving": path["serving"],
            "recall": metrics, "floors": floors, "sharded": sharded,
            **graph_summary(path)}


# ---------------------------------------------------------------------------
# phase 7: the split tree, the multi-database engine and the command lines,
# on the SIFT1M fixture
# ---------------------------------------------------------------------------

def phase_checks(label, metrics, serving, jax_cpu, launches, base=None):
    """A path's recall against its floors (0.03 below the JAX package's on
    the CPU, and at least `base`'s threshold of a metric where given) and
    its launch counts and recall against the reference run's: (below
    floor, differing)."""
    floors = {key: round(max(v - 0.03, (base or {}).get(key, 0.0)), 4)
              for key, v in jax_cpu.items()}
    failed = report(label, metrics, serving, jax_cpu, "JAX on the CPU",
                    floors)
    return failed, differs_from_reference(label, launches, metrics)


def same_results(torch, a, b):
    """Whether two runs' outputs (lists of QueryResult by mode) are equal to
    the bit (`same_output`)."""
    return all(same_output(torch, x, y)
               for mode in a for x, y in zip(a[mode], b[mode]))


def split_phase(torch, P, fx, workdir):
    """The split tree: trained on the 200k training rows (percent 0.3),
    every one of the 1M routed through mark_dense_vectors_for, both
    members built with raw vectors on the card; line, exact and refine at
    batch 256; then a save and a load whose results equal those before."""
    from pqt_tpu_torch.models import split as S
    from pqt_tpu_torch.utils.metrics import occupancy_histogram
    cfg, data, qd = fx["cfg"], fx["data"], fx["qd"]
    t0 = time.perf_counter()
    sdb = S.build_split_database(cfg, data, 0.3, keep_vectors=True,
                                 train_data=data[:N_TRAIN], device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    share = sdb.dense_ids.shape[0] / N_DB
    occupancy = {m: occupancy_histogram(getattr(sdb, m + "_db").counts
                                        .cpu().numpy())
                 for m in ("dense", "sparse")}
    print(f"split: train and build {build_s:.2f} s, dense share "
          f"{share:.4f} ({sdb.dense_ids.shape[0]} of {N_DB}); occupancy "
          f"{json.dumps(occupancy)}", flush=True)

    def modes(s, eager=False):
        query = entry(S.query_knn_split, eager)
        return {"line": lambda x: query(cfg, s, x, K),
                "exact": lambda x: query(cfg, s, x, K, True),
                "refine": lambda x: query(cfg, s, x, K, False, True)}

    path = serve_path(torch, "split path", modes(sdb), qd, SPLIT_KERNELS,
                      eager=modes(sdb, True), partner=fx["partner"])
    t_save = time.perf_counter()
    base = os.path.join(workdir, "split")
    S.save_split_database(base, cfg, sdb)
    loaded = S.load_split_database(base, cfg, device="cuda")
    again = {m: [fn(qd[s:s + BATCH]) for s in range(0, N_QUERIES, BATCH)]
             for m, fn in modes(loaded).items()}
    reload_equal = same_results(torch, path["outputs"], again)
    save_load_s = time.perf_counter() - t_save
    print(f"split: save and load {save_load_s:.2f} s; the "
          f"loaded split's results "
          f"{'equal' if reload_equal else 'DIFFER from'} those before",
          flush=True)
    metrics = path_recall(torch, "split", path["outputs"], fx["gt"])
    print("split floors (the pair path's thresholds, or 0.03 below JAX on "
          "the CPU where that is higher): " + json.dumps({
              key: round(max(JAX_CPU_SPLIT[key] - 0.03, THRESHOLDS[key]), 4)
              for key in ("exact_R@1", "line_top10_intersection",
                          "refine_R@1")}), flush=True)
    failed, changed = phase_checks("split", metrics, path["serving"],
                                   JAX_CPU_SPLIT, path["launches"],
                                   THRESHOLDS)
    if not reload_equal:
        failed.append("split: the loaded split's results differ")
    return dict(build_s=build_s, dense_share=share, occupancy=occupancy,
                save_load_s=save_load_s, reload_equal=reload_equal,
                launches=path["launches"], serving=path["serving"],
                recall=metrics, **graph_summary(path)), failed, changed


def multidb_modes(M, cfg, tree, mdb, eager=False):
    query = entry(M.query_multi_knn, eager)
    return {"occurrence": lambda x: query(cfg, tree, mdb, x, K),
            "distance": lambda x: query(
                cfg.replace(multidb_rank="distance"), tree, mdb, x, K),
            "exact": lambda x: query(cfg, tree, mdb, x, K, True)}


def occurrence_top_plain(torch, dists, occ, cand_ids, k):
    """The occurrence ranking as the JAX package sorts it (finite first,
    occurrences descending, line distance ascending, ties by slot): stable
    torch.sort passes, the least significant key first.  (ids, -1 where
    the distance is +inf; dists) (B, k)."""
    finite = torch.isfinite(dists)
    order = torch.sort(dists, dim=1, stable=True)[1]
    for key in (torch.where(finite, -occ, 0), (~finite).to(torch.int32)):
        order = torch.gather(order, 1, torch.sort(
            torch.gather(key, 1, order), dim=1, stable=True)[1])
    d = torch.gather(dists, 1, order[:, :k])
    ids = torch.gather(cand_ids, 1, order[:, :k])
    return torch.where(torch.isfinite(d), ids, -1), d


def multidb_phase(torch, P, fx, workdir):
    """The multi-database engine over the pair path's tree: group_parts 2,
    raw vectors, the pair filter on; occurrence and distance line and exact
    at batch 256; `_duplicate_stats` timed on one batch's candidates, whose
    occurrence ranking must equal `occurrence_top_plain`'s to the bit; then
    a rebuild whose payloads spill to disk, placed on the card once, whose
    results equal the in-memory build's to the bit, and whose serving
    copies no host bytes."""
    from pqt_tpu_torch.models import db as D
    from pqt_tpu_torch.models import multidb as M
    from pqt_tpu_torch.utils.metrics import occupancy_histogram
    cfg, tree, data, qd = (fx["cfg"].replace(pair_filter=True), fx["tree"],
                           fx["data"], fx["qd"])
    t0 = time.perf_counter()
    mdb = M.build_multi_database(cfg, tree, data, 2, keep_vectors=True,
                                 device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    occupancy = [occupancy_histogram(d.counts.cpu().numpy())
                 for d in mdb.databases]
    print(f"multidb: build {build_s:.2f} s, {mdb.n_groups} groups, "
          f"occupancy {json.dumps(occupancy)}", flush=True)
    path = serve_path(torch, "multi-DB path",
                      multidb_modes(M, cfg, tree, mdb), qd, MULTIDB_KERNELS,
                      eager=multidb_modes(M, cfg, tree, mdb, True),
                      partner=fx["partner"])
    metrics = path_recall(torch, "multidb", path["outputs"], fx["gt"])
    failed, changed = phase_checks("multidb", metrics, path["serving"],
                                   JAX_CPU_MULTIDB, path["launches"])
    # the dedup's and the occurrence ranking's inputs, caught on one batch
    # of the eager body: the dedup's share of the batch, and the ranking
    # (kernel A twice) against the JAX package's lexicographic sort by
    # torch.sort
    caught = {}
    dup_stats, occ_top = M._duplicate_stats, M._occurrence_top
    M._duplicate_stats = lambda c, v: caught.update(c=c, v=v) or \
        dup_stats(c, v)
    M._occurrence_top = lambda *a: caught.update(occ=a) or occ_top(*a)
    try:
        M.query_multi_knn.__wrapped__(cfg, tree, mdb, qd[:BATCH], K)
    finally:
        M._duplicate_stats, M._occurrence_top = dup_stats, occ_top
    dup_ms = device_ms(torch, lambda: dup_stats(caught["c"], caught["v"]))
    busy = path["profiles"]["occurrence"]["replay"].get("device_busy_ms")
    print(f"multidb: _duplicate_stats on a batch's {tuple(caught['c'].shape)}"
          f" candidates {dup_ms:.4f} ms of the occurrence batch's "
          f"{busy if busy is None else f'{busy:.4f}'} ms device busy",
          flush=True)
    got, want = occ_top(*caught["occ"]), occurrence_top_plain(
        torch, *caught["occ"])
    occ_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    sd = torch.sort(caught["occ"][0], dim=1)[0]
    ties = int(((sd[:, 1:] == sd[:, :-1]) & torch.isfinite(sd[:, 1:])).sum())
    print(f"multidb: the occurrence ranking of one batch "
          f"{'equals' if occ_equal else 'DIFFERS from'} its plain route "
          f"(stable torch.sort passes) to the bit; {ties} finite distances "
          "tie with the one before", flush=True)
    if not occ_equal:
        failed.append("multidb: the occurrence ranking differs from its "
                      "plain route")

    t0 = time.perf_counter()
    host = M.build_multi_database(cfg, tree, data, 2, keep_vectors=True,
                                  spill_path=os.path.join(workdir, "mdb"),
                                  device="cuda")
    spill_s = time.perf_counter() - t0
    if not all(isinstance(d.payload, np.memmap) for d in host.databases):
        failed.append("multidb_spill: the payloads are not on disk")
    payload_bytes = sum(d.payload.nbytes for d in host.databases)
    before = D.to_device.bytes_copied
    placed = M.place_multi_database(host, "cuda")
    torch.cuda.synchronize()
    uploaded = D.to_device.bytes_copied - before
    before = D.to_device.bytes_copied
    spilled = serve_path(torch, "spilled multi-DB path",
                         multidb_modes(M, cfg, tree, placed), qd,
                         MULTIDB_KERNELS,
                         eager=multidb_modes(M, cfg, tree, placed, True),
                         partner=fx["partner"])
    copied = D.to_device.bytes_copied - before
    equal = same_results(torch, path["outputs"], spilled["outputs"])
    print(f"multidb_spill: build {spill_s:.2f} s, {payload_bytes} payload "
          f"bytes on disk, {uploaded} bytes uploaded once, {copied} bytes "
          f"copied while serving; results "
          f"{'equal' if equal else 'DIFFER from'} the in-memory build's",
          flush=True)
    if uploaded != payload_bytes or copied != 0:
        failed.append("multidb_spill: the payload was not uploaded exactly "
                      "once")
    if not equal:
        failed.append("multidb_spill: results differ from the in-memory "
                      "build's")
    changed += differs_from_reference("multidb_spill", spilled["launches"],
                                      path_recall(torch, "multidb_spill",
                                                  spilled["outputs"],
                                                  fx["gt"]))
    return (dict(build_s=build_s, occupancy=occupancy,
                 launches=path["launches"], serving=path["serving"],
                 recall=metrics, duplicate_stats_ms=dup_ms,
                 **graph_summary(path)),
            dict(build_s=spill_s, payload_bytes=payload_bytes,
                 uploaded_bytes=uploaded, serving_copied_bytes=copied,
                 launches=spilled["launches"], serving=spilled["serving"],
                 **graph_summary(spilled)),
            failed, changed)


def run_main(main_fn, argv):
    """A command line's main in this process, its printed lines echoed."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    text = out.getvalue()
    for line in text.splitlines():
        print(f"  | {line}", flush=True)
    return text


def write_cli_files(texmex, d, data, queries, gt):
    """The command lines' inputs in d: base and queries as .bvecs, the
    exact top-100 as .ivecs, written by either package's `texmex`."""
    texmex.write_xvecs(f"{d}/base.bvecs", data)
    texmex.write_xvecs(f"{d}/query.bvecs", queries.astype(np.uint8))
    texmex.write_xvecs(f"{d}/gt.ivecs", gt.astype(np.int32))


def cli_args(d):
    """The arguments of `convert`, `create_db` and `query` over the files
    in d: SIFT1M widths with hash 2^20, chunks of 250k, raw vectors, 8
    k-means iterations on N_TRAIN rows; the query at 512 bins, 1024
    candidates, k1 8, exact re-rank, batch BATCH.  Both packages' tools
    take them (the port's also `--device`)."""
    widths = ["--p", "4", "--c1", "16", "--c2", "16", "--lineparts", "16",
              "--hashsize", str(1 << 20)]
    return (["--src", f"{d}/base.bvecs", "--dst", f"{d}/base.umem"],
            ["--dataset", f"{d}/base.umem", "--basename", f"{d}/sift",
             "--chunksize", "250000", "--train-size", str(N_TRAIN),
             "--kmeans-iters", "8", "--keep-vectors"] + widths,
            ["--basename", f"{d}/sift", "--queries", f"{d}/query.bvecs",
             "--groundtruth", f"{d}/gt.ivecs", "--dim", "128", "--k", str(K),
             "--k1", "8", "--maxbins", "512", "--candidates", "1024",
             "--batch", str(BATCH), "--exact-rerank"] + widths)


def cli_recall(text):
    """The recall `query --groundtruth` printed, as exact_* metrics, and
    its printed QPS."""
    import ast
    import re
    printed = ast.literal_eval(re.search(r"recall: (\{.*\})", text).group(1))
    return ({f"exact_{k}": v for k, v in printed.items()},
            float(re.search(r"-> (\d+) QPS", text).group(1)))


def cli_runner(query, args, eager):
    """The query tool's batch function (`load_runner`), or with `eager` the
    same over the entry points' eager bodies."""
    import torch
    from pqt_tpu_torch.models import query as Q
    graphed = Q.query_knn, Q.query_knn_refine
    if eager:
        Q.query_knn, Q.query_knn_refine = (f.__wrapped__ for f in graphed)
    try:
        return query.load_runner(args, torch.device("cuda"))[1]
    finally:
        Q.query_knn, Q.query_knn_refine = graphed


def cli_phase(torch, P, fx, workdir):
    """The command lines on the fixture (`cli_args`): `convert` to .umem,
    `create_db --mode full`, and `query --exact-rerank --groundtruth`, all
    in this process; its printed recall is parsed.  Then the query tool's
    own batch function is served by the window protocol, replayed and over
    the eager bodies (`cli_runner`), and held to `graph_checks`."""
    from pqt_tpu_torch.io import texmex
    from pqt_tpu_torch.tools import convert, create_db, query
    d = os.path.join(workdir, "cli")
    os.makedirs(d)
    t0 = time.perf_counter()
    write_cli_files(texmex, d, fx["data"], fx["queries"], fx["gt"])
    times = {"write_s": time.perf_counter() - t0}
    conv, create, serve_args = cli_args(d)
    on_card = ["--device", "cuda"]
    t0 = time.perf_counter()
    run_main(convert.main, conv)
    times["convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_main(create_db.main, create + on_card)
    times["create_db_s"] = time.perf_counter() - t0
    reset_launches(torch)
    t0 = time.perf_counter()
    out = run_main(query.main, serve_args + on_card)
    times["query_s"] = time.perf_counter() - t0
    launches = read_launches("command-line query", CLI_KERNELS)
    metrics, qps = cli_recall(out)
    print(f"cli: write {times['write_s']:.1f} s, convert "
          f"{times['convert_s']:.1f} s, create_db {times['create_db_s']:.1f}"
          f" s, query {times['query_s']:.1f} s ({qps:.0f} QPS printed)",
          flush=True)
    failed, changed = phase_checks("cli", metrics, {}, JAX_CPU_CLI,
                                   launches, THRESHOLDS)
    # the query tool's batch function, served by the window protocol as it
    # runs (replays) and with the entry points' eager bodies in its place
    args = query.parse_args(serve_args + on_card)
    runs = {eager: {"exact": cli_runner(query, args, eager)}
            for eager in (False, True)}
    path = serve_path(torch, "command-line query's batch function",
                      runs[False], fx["qd"], CLI_KERNELS, eager=runs[True],
                      partner=fx["partner"])
    # phase 8's command line: the same query over one hash-range shard,
    # loaded on the host and placed on the card; the same recall printed
    sharded = serve_args + ["--sharded", "1"] + on_card
    from pqt_tpu_torch.parallel import sharded as S
    made, make = [], S.make_sharded_query_fn
    S.make_sharded_query_fn = lambda *a, **kw: made.append(
        make(*a, **kw)) or made[-1]
    reset_launches(torch)
    t0 = time.perf_counter()
    try:
        out = run_main(query.main, sharded)
    finally:
        S.make_sharded_query_fn = make
    times["query_sharded_s"] = time.perf_counter() - t0
    tool_graphs = [e for fn in made for e in fn.graphs.values()]
    replays = sum(e.replays for e in tool_graphs)
    print(f"cli: query --sharded 1 served {replays} batches by replays of "
          f"{len(tool_graphs)} graphed sharded step entries (stages "
          f"{[len(e.stages) for e in tool_graphs]})", flush=True)
    if not replays:
        failed.append("cli_sharded: no batch replayed the sharded step's "
                      "graphs")
    for fn in made:
        fn.graphs.clear()
    sh_launches = read_launches("command-line query with --sharded 1",
                                SHARDED_EXACT_KERNELS)
    sh_metrics, sh_qps = cli_recall(out)
    same = sh_metrics == metrics
    print(f"cli: query --sharded 1 {times['query_sharded_s']:.1f} s "
          f"({sh_qps:.0f} QPS printed); its recall "
          f"{'equals' if same else 'DIFFERS from'} the unsharded query's to "
          "the last digit", flush=True)
    if not same:
        failed.append("cli_sharded: recall differs from the unsharded "
                      "query's")
    changed += differs_from_reference("cli_sharded", sh_launches, sh_metrics)
    _, run = query.load_runner(query.parse_args(sharded),
                               torch.device("cuda"))
    sh_profile = profile_batch(torch, run, fx["qd"][:BATCH])
    print("profile cli_sharded exact (the query tool's batch function): "
          + json.dumps(sh_profile), flush=True)
    return (dict(times=times, qps=qps, launches=launches, recall=metrics,
                 **graph_summary(path),
                 sharded={"qps": sh_qps, "launches": sh_launches,
                          "recall": sh_metrics,
                          "profiles": {"exact": sh_profile}}),
            failed, changed)


def phase7_paths(torch, P, fx):
    """Phase 7: split, multi-DB (in memory, then spilled) and the command
    lines, each with the launch counts reset just before it; one failure
    message for all of them at the end."""
    out, failed, changed = {}, [], []
    with tempfile.TemporaryDirectory(prefix="pqt_smoke_") as workdir:
        out["split"], f, c = split_phase(torch, P, fx, workdir)
        failed, changed = failed + f, changed + c
        out["multidb"], out["multidb_spill"], f, c = multidb_phase(
            torch, P, fx, workdir)
        failed, changed = failed + f, changed + c
        out["cli"], f, c = cli_phase(torch, P, fx, workdir)
        failed, changed = failed + f, changed + c
    if failed:
        raise SmokeFailure(f"split, multi-DB or command-line path failed: "
                           f"{failed}")
    if changed:
        raise SmokeFailure(f"launch counts or recall differ from the "
                           f"reference run's: {changed}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the sharded serving layer, on the one card
# ---------------------------------------------------------------------------

def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_modes(S, cfg, tree, sdb, devices, modes, batch_split=1,
                  group=None):
    """The sharded query step of each mode in `modes` over `sdb` on
    `devices`, as one-argument functions of a batch: (the steps as users
    call them, replaying their graphs; their eager bodies).  The steps
    join SHARDED_STEPS."""
    fns = {m: S.make_sharded_query_fn(cfg, devices, K, mode=m,
                                      n_intermediate=256,
                                      batch_split=batch_split, group=group)
           for m in modes}
    SHARDED_STEPS.extend(fns.values())
    return tuple({m: (lambda x, fn=entry(fn, eager): fn(tree, sdb, x))
                  for m, fn in fns.items()} for eager in (False, True))


def world_of_one(D):
    """This process alone in an NCCL process group (the card's collectives
    run, with no peer): its device."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    return D.initialize(f"localhost:{free_port()}", 1, 0, 300,
                        device="cuda")


def aligned_bounds(n, parts, step=65536):
    """Row bounds of `parts` chunk files at multiples of `step` (the build's
    encode chunk), so each file's encode steps are the build's own and the
    merged database equals the build's to the bit."""
    per = -(-n // (parts * step)) * step
    return list(range(0, n, per)) + [n]


def dp_programs(torch, S, cfg, tree, db, grid, out):
    """Phase 8's data-parallel programs on the pair path's database: the
    encode over the grid's entries of the card, against the build's
    payload and counts; one k-means step (256 centroids), within 1e-4 of
    the one-device step; each replayed (the first call capturing, a second
    all replays) and eager, equal to the bit.  Adds its numbers to `out`;
    returns the failures."""
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.utils import graphs as G
    failed = []
    encode = S.make_dp_encode_fn(cfg, grid)
    reset_launches(torch)
    (bins, codes, t3), out["dp_encode_s"] = timed(
        torch, lambda: encode(tree, db.vectors))
    out["dp_encode_launches"] = read_launches("data-parallel encode",
                                              BUILD_KERNELS)
    again, out["dp_encode_replayed_s"] = timed(
        torch, lambda: encode(tree, db.vectors))
    with G.eager():
        eager_enc, out["dp_encode_eager_s"] = timed(
            torch, lambda: encode(tree, db.vectors))
    dp_same = all(same_output(torch, a, b) for a, b in zip(
        (bins, codes, t3), eager_enc)) and all(
        same_output(torch, a, b) for a, b in zip(again, eager_enc))
    del again, eager_enc
    ids = torch.arange(N_DB, dtype=torch.int32, device="cuda")
    packed = DB.pack_payload_device(cfg, ids, codes, t3)[
        torch.sort(bins, stable=True).indices]
    enc_equal = torch.equal(packed, db.payload) and torch.equal(
        torch.bincount(bins, minlength=cfg.hash_size).to(torch.int32),
        db.counts)
    del bins, codes, t3, packed, ids
    gen = torch.Generator(device="cuda").manual_seed(0)
    cents = db.vectors[torch.randint(0, N_DB, (256,), generator=gen,
                                     device="cuda")].to(torch.float32)
    step = S.make_dp_kmeans_step(grid)
    DP_STEPS.append(step)
    got, out["dp_kmeans_s"] = timed(torch, lambda: step(db.vectors, cents))
    replayed, out["dp_kmeans_replayed_s"] = timed(
        torch, lambda: step(db.vectors, cents))
    with G.eager():
        eager_km, out["dp_kmeans_eager_s"] = timed(
            torch, lambda: step(db.vectors, cents))
    dp_same = dp_same and same_output(torch, got, eager_km) and \
        same_output(torch, replayed, eager_km)
    want = S.make_dp_kmeans_step(["cuda"]).__wrapped__(db.vectors, cents)
    out["dp_kmeans_max_abs_err"] = float((got - want).abs().max())
    km_ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    out["dp_graphs"] = build_graphs_report("the data-parallel programs")
    del got, want, replayed, eager_km
    verdict = "equal" if dp_same else "DIFFER from"
    print(f"sharded: data-parallel encode of {N_DB} rows over "
          f"{len(grid)} entries of the card {out['dp_encode_s']:.3f} s "
          f"(first call, capturing), {out['dp_encode_replayed_s']:.3f} s "
          f"replayed, {out['dp_encode_eager_s']:.3f} s eager, "
          f"{'equal' if enc_equal else 'NOT equal'} to the build's payload "
          f"and counts to the bit; one data-parallel k-means step (256 "
          f"centroids) {out['dp_kmeans_s']:.4f} s (first call), "
          f"{out['dp_kmeans_replayed_s']:.4f} s replayed, "
          f"{out['dp_kmeans_eager_s']:.4f} s eager, max abs difference "
          f"{out['dp_kmeans_max_abs_err']:.3g} from the one-device step "
          f"({'within' if km_ok else 'NOT within'} rtol = atol = 1e-4); "
          f"the replayed encode and step {verdict} the eager bodies' to the "
          f"bit [{card_line()}]", flush=True)
    if not enc_equal:
        failed.append("dp_encode: differs from the build's encode")
    if not km_ok:
        failed.append("dp_kmeans: differs from the one-device step")
    if not dp_same:
        failed.append("dp programs: a replayed result differs from the "
                      "eager body's")
    out.update(dp_encode_equal=enc_equal, dp_replays_equal=dp_same)
    return failed


def dp_kmeans_through(torch, S, grid, vectors, group):
    """The data-parallel k-means step through `group` (its all_reduces in
    the merge's graph), served three times: whether every result equals
    the step without a group to the bit, from one graph of that group
    replayed twice."""
    km = S.make_dp_kmeans_step(grid, group=group)
    DP_STEPS.append(km)
    cents = vectors[:256].to(torch.float32)
    want = S.make_dp_kmeans_step(grid).__wrapped__(vectors, cents)
    got = [km(vectors, cents) for _ in range(3)]
    (entry,) = km.graphs.values()
    return entry.group is group and entry.replays == 2 and all(
        same_output(torch, g, want) for g in got)


def sharded_phase(torch, P, fx, single, workdir):
    """Phase 8 on the SIFT1M fixture: the pair path's database in N_SHARDS
    hash-range shards on the card (shard_database over its leaves brought
    to the host, place_sharded_db), line, exact and big at batch 256, exact
    again with the batch in 2 slices over a (4, 2) grid (equal to the bit),
    the data-parallel encode of the 1M vectors over 4 entries of the card
    (equal to the build's payload and counts to the bit), one data-parallel
    k-means step (within 1e-4 of the one-device step), and the
    multi-process chain in a world of one NCCL rank: the fixture in 4 chunk
    files, merge_chunk_files_range, build_local_shards,
    place_host_sharded_db, peer_barrier and the exact query through the
    group (equal to the in-process result to the bit).  Returns (numbers,
    failures, differences from the reference run)."""
    import torch.distributed as dist
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.parallel import distributed as D
    from pqt_tpu_torch.parallel import sharded as S
    cfg, tree, db, data, qd, gt = (fx[k] for k in ("cfg", "tree", "db",
                                                   "data", "qd", "gt"))
    failed, out = [], {}
    t0 = time.perf_counter()
    host = db._replace(**{f: getattr(db, f).cpu().numpy()
                          for f in db._fields if getattr(db, f) is not None})
    shards = S.shard_database(cfg, host, N_SHARDS)
    grid = ["cuda"] * N_SHARDS
    sdb = S.place_sharded_db(shards, grid)
    torch.cuda.synchronize()
    out["shard_place_s"] = time.perf_counter() - t0
    print(f"sharded: {N_SHARDS} shards of {cfg.hash_size // N_SHARDS} slots,"
          f" rows {shards.n_per_shard.tolist()} padded to "
          f"{shards.payload.shape[1]}; shard and place "
          f"{out['shard_place_s']:.2f} s", flush=True)
    paths = {}
    for mode, required in (("line", PAIR_KERNELS),
                           ("exact", SHARDED_EXACT_KERNELS),
                           ("big", BIG_KERNELS)):
        modes, eager = sharded_modes(S, cfg, tree, sdb, grid, (mode,))
        paths[f"sharded_{mode}"] = serve_path(
            torch, f"sharded path ({mode})", modes, qd, required,
            eager=eager, partner=fx["partner"])
    grid2 = ["cuda"] * (2 * N_SHARDS)
    modes, eager = sharded_modes(
        S, cfg, tree, S.place_sharded_db(shards, grid2), grid2, ("exact",),
        batch_split=2)
    paths["sharded_exact_split"] = serve_path(
        torch, "sharded path (exact, the batch split over a 4x2 grid)",
        modes, qd, SHARDED_EXACT_KERNELS, eager=eager, partner=fx["partner"])
    split_equal = same_results(torch, paths["sharded_exact"]["outputs"],
                               paths["sharded_exact_split"]["outputs"])
    print(f"sharded: the batch split's results "
          f"{'equal' if split_equal else 'DIFFER from'} the unsplit ones "
          "to the bit", flush=True)
    if not split_equal:
        failed.append("sharded: the batch split changes the results")

    failed += dp_programs(torch, S, cfg, tree, db, grid, out)

    # the multi-process chain, in a world of one NCCL rank
    bcfg = cfg.replace(pair_filter=True)      # as the database was built
    bounds = aligned_bounds(N_DB, N_SHARDS)
    chunk_paths = []
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        chunk_paths.append(os.path.join(workdir, f"sift1m_chunk{i}.npz"))
        P.encode_chunk_to_file(bcfg, tree, data[a:b], a, chunk_paths[-1],
                               keep_vectors=True, device="cuda")
    out["chunk_encode_s"] = time.perf_counter() - t0
    from pqt_tpu_torch.models.db import merge_chunk_files_range
    dev = world_of_one(D)
    try:
        out["backend"] = dist.get_backend()
        mesh = D.global_device_mesh([dev] * N_SHARDS)
        my = D.local_shard_ids(mesh)
        lo, hi = D.host_shard_range(cfg, N_SHARDS, my)
        t0 = time.perf_counter()
        prefix, counts, payload, vec_csr, occ = merge_chunk_files_range(
            bcfg, chunk_paths, lo, hi, keep_vectors=True)
        local = D.build_local_shards(cfg, N_SHARDS, my, prefix, counts,
                                     payload, vectors_csr=vec_csr)
        placed = D.place_host_sharded_db(cfg, local, mesh, pair_occ=occ)
        D.peer_barrier(timeout_s=120)
        out["chain_s"] = time.perf_counter() - t0
        leaves_equal = all(np.array_equal(getattr(local, f),
                                          getattr(shards, f))
                           for f in ("prefix", "counts", "prefix2",
                                     "payload", "n_per_shard", "vectors"))
        modes, eager = sharded_modes(S, cfg, tree, placed, mesh,
                                     ("exact",), group=dist.group.WORLD)
        # the all_gather and all_reduce are nodes of the merge's graph:
        # its replays of every batch must equal the eager results
        paths["sharded_nccl"] = serve_path(
            torch, f"sharded path (exact, a world of one "
            f"{out['backend']} rank, its collectives captured)", modes, qd,
            SHARDED_EXACT_KERNELS, eager=eager, partner=fx["partner"])
        nccl_graphs = [e.group is dist.group.WORLD for e in graph_entries()
                       if e.group is not None]
        km_group_equal = dp_kmeans_through(torch, S, grid, db.vectors,
                                           dist.group.WORLD)
    finally:
        clear_sharded_graphs()
        clear_build_graphs()
        dist.destroy_process_group()
    verdict = "equal" if km_group_equal else "NOT equal"
    print(f"sharded: the data-parallel k-means step through the "
          f"{out['backend']} group, its all_reduces captured in the merge's "
          f"graph, replayed twice: {verdict} to the step without a group to "
          "the bit", flush=True)
    if not km_group_equal:
        failed.append("dp_kmeans through the group: differs from the step "
                      "without one")
    if nccl_graphs != [True]:
        failed.append(f"sharded_nccl: {len(nccl_graphs)} graphs hold the "
                      "group's collectives, not 1")
    nccl_equal = same_results(torch, paths["sharded_exact"]["outputs"],
                              paths["sharded_nccl"]["outputs"])
    print(f"sharded: {out['backend']} world of one: {len(chunk_paths)} chunk "
          f"files encoded {out['chunk_encode_s']:.2f} s, merge, shards, "
          f"placement and barrier {out['chain_s']:.2f} s; its shards "
          f"{'equal' if leaves_equal else 'DIFFER from'} shard_database's "
          f"and its results {'equal' if nccl_equal else 'DIFFER from'} the "
          "in-process ones to the bit", flush=True)
    if not nccl_equal:
        failed.append("sharded_nccl: results differ from the in-process "
                      "sharded exact query's")

    # recall: not more than SHARDED_SLACK below the same mode on one
    # device, nor 0.03 below the JAX package's 4-shard CPU run
    ref = dict(single["pair"]["recall"])
    ref.update({key.replace("big_line_", "big_"): v
                for key, v in single["big_line"]["recall"].items()})
    changed = differs_from_reference("dp_encode", out["dp_encode_launches"])
    out["paths"] = {}
    for label, path in paths.items():
        metrics = path_recall(torch, label, path["outputs"], gt)
        floors = {key: round(max(ref[key] - SHARDED_SLACK,
                                 JAX_CPU_SHARDED[key] - 0.03), 4)
                  for key in metrics}
        failed += report(label, metrics, path["serving"],
                         {key: ref[key] for key in metrics},
                         "single device", floors)
        changed += differs_from_reference(label, path["launches"], metrics)
        out["paths"][label] = {"launches": path["launches"],
                               "serving": path["serving"], "recall": metrics,
                               "floors": floors, **graph_summary(path)}
    out.update(split_equal=split_equal, nccl_equal=nccl_equal,
               nccl_leaves_equal=leaves_equal,
               dp_kmeans_group_equal=km_group_equal)
    return out, failed, changed


def sift1b_sharded(torch, cfg, tree, chunk_paths, qd, gt, single):
    """The SIFT1B phase's chunk files served over N_SHARDS shards of
    hash_size / N_SHARDS slots in a world of one NCCL rank: the range merge
    on the host, build_local_shards, place_host_sharded_db, then exact over
    the shards' vectors and line at batch 64.  Returns (numbers, recall
    below its floors, differences from the reference run)."""
    import torch.distributed as dist
    from pqt_tpu_torch.models.db import merge_chunk_files_range
    from pqt_tpu_torch.parallel import distributed as D
    from pqt_tpu_torch.parallel import sharded as S
    torch.cuda.reset_peak_memory_stats()
    out = {}
    dev = world_of_one(D)
    try:
        mesh = D.global_device_mesh([dev] * N_SHARDS)
        my = D.local_shard_ids(mesh)
        lo, hi = D.host_shard_range(cfg, N_SHARDS, my)
        t0 = time.perf_counter()
        prefix, counts, payload, vec_csr, occ = merge_chunk_files_range(
            cfg, chunk_paths, lo, hi, keep_vectors=True)
        out["merge_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        local = D.build_local_shards(cfg, N_SHARDS, my, prefix, counts,
                                     payload, vectors_csr=vec_csr)
        del prefix, counts, payload, vec_csr
        out["split_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        placed = D.place_host_sharded_db(cfg, local, mesh, pair_occ=occ)
        torch.cuda.synchronize()
        out["place_s"] = time.perf_counter() - t0
        out["rows"] = local.n_per_shard.tolist()
        out["budget"] = int(local.payload.shape[1])
        del local
        D.peer_barrier(timeout_s=120)
        out["held_device_gib"] = torch.cuda.memory_allocated() / 2 ** 30
        modes, eager = sharded_modes(S, cfg, tree, placed, mesh,
                                     ("exact", "line"),
                                     group=dist.group.WORLD)
        path = serve_path(torch, "SIFT1B sharded path", modes, qd,
                          SHARDED_EXACT_KERNELS + ("rerank_fused",),
                          ("bitonic_topk:cluster",), batch=BATCH_1B,
                          eager=eager)
    finally:
        clear_sharded_graphs()
        dist.destroy_process_group()
    rss = host_rss_gib()
    out.update(peak_device_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               host_rss_gib=rss[0], host_peak_rss_gib=rss[1])
    print(f"sift1b_sharded: {N_SHARDS} shards of {cfg.hash_size // N_SHARDS}"
          f" slots, rows {out['rows']} padded to {out['budget']}; range "
          f"merge {out['merge_s']:.1f} s, shards {out['split_s']:.1f} s, "
          f"placement {out['place_s']:.1f} s; device memory held "
          f"{out['held_device_gib']:.2f} GiB, peak "
          f"{out['peak_device_gib']:.2f}; host RSS {rss[0]:.2f} GiB (peak "
          f"{rss[1]:.2f})", flush=True)
    metrics = path_recall(torch, "sift1b_sharded", path["outputs"], gt)
    floors = {key: round(max(single[key] - SHARDED_SLACK,
                             SIFT1B_FLOORS.get(key, 0.0)), 4)
              for key in metrics}
    failed = report("sift1b_sharded", metrics, path["serving"],
                    {key: single[key] for key in metrics},
                    "single device", floors)
    changed = differs_from_reference("sift1b_sharded", path["launches"],
                                     metrics)
    out.update(launches=path["launches"], serving=path["serving"],
               recall=metrics, floors=floors, **graph_summary(path))
    return out, failed, changed


# kernel E/F/G rows: one CUDA kernel stands for the three TPU lookups
LUT_ROWS = (("lut_gather", "benchmarks/micro_gather.py:32"),
            ("lut_gather:lut_2d", "benchmarks/micro_gather2.py:39"),
            ("lut_gather:lut_onehot", "benchmarks/micro_gather2.py:69"))


def main(json_path=None):
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: chip_smoke "
                           "needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    import pqt_tpu_torch as P
    from pqt_tpu_torch.ops.cuda import build
    print("tf32: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeFailure("TF32 matmuls are on")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    nvcc_s = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {nvcc_s:.2f} s)", flush=True)

    kernels, floor = check_kernels(torch)
    check_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in kernels.values():
        print(f"{r['name']:16s} ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {r['library_ms']}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})  max_abs_err {r['max_abs_err']}", flush=True)
        for c in r["shapes"]:
            other = ""
            if "pass_bound_ms" in c:
                other += f"  passes' bound {c['pass_bound_ms']:.4f}"
            if "sector_bound_ms" in c:
                other += f"  sectors' bound {c['sector_bound_ms']:.4f}"
            if "old_route_ms" in c:
                other += f"  old route {c['old_route_ms']:.4f}"
            for key in ("cold_ms", "cold_library_ms", "cold_old_route_ms"):
                if key in c:
                    other += f"  {key[:-3].replace('_', ' ')} {c[key]:.4f}"
            if "reads" in c:
                other += f"  reads {c['reads']:.2f}"
            if c.get("sort_ms"):
                other += f"  torch.sort {c['sort_ms']:.4f}"
            for label, ms in c.get("other_routes", {}).items():
                other += f"  {label} {ms:.4f}"
                if label in c["other_reads"]:
                    other += f" (reads {c['other_reads'][label]:.2f})"
            for mode, ms in c.get("other_modes", {}).items():
                other += f"  {mode} mode {ms:.4f}"
            if "onepass_replay_ms" in c:
                other += (f"  onepass replayed {c['onepass_replay_ms']:.4f}"
                          f" (eager {c['onepass_eager_ms']:.4f}, the "
                          "replays equal to the plain version)")
            print(f"    {c['case']:64s} ms {c['ms']:.4f}  plain "
                  f"{c['plain_ms']:.4f}  library {c['library_ms']}  bound "
                  f"{c['bound_ms']:.4f}{other}", flush=True)
    print(f"launch floor {floor:.4f} ms", flush=True)
    print(f"kernel checks: peak device memory {check_peak:.2f} GiB",
          flush=True)
    print(f"timings taken with CUDA events (no profiler session recorded "
          f"device time): {len(EVENT_TIMED)}", flush=True)

    check_other_paths(torch)
    print("other kernel paths (hard top-k rows in every mode, multi-row long "
          "scans, ragged scan widths, segments of 1 to 130 in both modes, "
          "ragged lookups, row gathers in every unit and span, line "
          "re-ranks in every mode and copy unit, line-code selections on "
          "hard rows at both lambda widths, part codes on hard rows and "
          "every route, exact ones to the bit, others at most near-ties): "
          "equal to their plain versions", flush=True)

    summary, fixture = query_paths(torch, P)
    summary.update(phase7_paths(torch, P, fixture))
    with tempfile.TemporaryDirectory(prefix="pqt_sharded_") as workdir:
        summary["sharded"], failed8, changed8 = sharded_phase(
            torch, P, fixture, summary["paths"], workdir)
    del fixture
    clear_graphs()
    peak_before = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory(prefix="pqt_sift1b_") as workdir:
        summary["sift1b"] = sift1b_phase(torch, P, workdir)
    if failed8:
        raise SmokeFailure(f"sharded path failed: {failed8}")
    if changed8:
        raise SmokeFailure(f"sharded launch counts or recall differ from "
                           f"the reference run's: {changed8}")
    runs = [p["launches"] for p in summary["paths"].values()] + [
        summary[label]["launches"]
        for label in ("split", "multidb", "multidb_spill", "cli")] + [
        summary["sift1b"]["build_launches"], summary["sift1b"]["launches"],
        summary["cli"]["sharded"]["launches"],
        summary["sharded"]["dp_encode_launches"],
        summary["sift1b"]["sharded"]["launches"]] + [
        p["launches"] for p in summary["sharded"]["paths"].values()]
    launches = {c.__name__: sum(r[c.__name__] for r in runs)
                for c in counters()}
    rows = []
    sqdist = dict(kernels.pop("gather_sqdist"),
                  launches=launches["gather_sqdist"])
    # every launch of kernel C on the paths is gather_rerank's
    fused = dict(kernels.pop("gather_rerank"),
                 launches=launches["rerank_fused"])
    for r in kernels.values():
        r["launches"] = launches[r["name"]]
        if r["name"] in SQDIST_ROWS:
            r["modes"] = {"gather_sqdist": sqdist}
        if r["name"] == "rerank_fused":
            r["modes"] = {"gather_rerank": fused}
        if r["name"] != "lut_gather":
            rows.append(r)
            continue
        rows += [dict(r, name=name, replaces=where)
                 for name, where in LUT_ROWS]
    summary["card"] = card
    summary["launch_floor_ms"] = floor
    summary["kernel_check_peak_gib"] = check_peak
    summary["event_timed_ms"] = EVENT_TIMED
    summary["peak_memory_gib"] = max(peak_before / 2**30,
                                     summary["sift1b"]["peak_device_gib"])
    summary["run_s"] = time.perf_counter() - t_start
    print(f"run {summary['run_s']:.1f} s from the card check, peak device "
          f"memory {summary['peak_memory_gib']:.2f} GiB", flush=True)
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({"kernels": rows, **summary}, f, indent=1)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH",
                    help="also write every number of the run to PATH")
    args = ap.parse_args()
    try:
        main(args.json)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
