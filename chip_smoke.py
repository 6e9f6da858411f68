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
     of 65536-wide rows, also timed beside torch.sort); top-k and prefix
     sums run in the mode their wrapper picks and in every other mode that
     takes the shape (all held and timed), the segment sums of the encode
     also over a rotating set of inputs larger than L2 (cold, beside the
     warm repeats), the lookups and row gathers with
     a sectors' bound beside the byte bound, the exact distances
     (`gather_sqdist`, kernels H and D fused) beside the five launches they
     replaced (H's rows, the float copy, the difference, the square and
     D's row sums), the line re-rank warm and cold (candidates drawn anew
     over rows read 256 MiB earlier) beside its old route, warm and cold;
     then the kernels are held on inputs that are hard for them (not
     timed);
  4. the pair path at SIFT1M width: train a tree on 200k of bench.py's 1M
     SIFT-like vectors (seed 0), build the database of all 1M on the card
     (with the pair-occupancy table, which the pair path leaves unused),
     and serve 1024 held-out queries in batches of 256 through exact, line
     and refine query_knn and query_candidates;
  5. the parts path on the same tree and database: the parts pipeline with
     the pair filter through the same four entry points, then exact, line
     and query_candidates again with slab gathers (32 rows a slab);
  6. the BIG two-stage path on the same database, line (n_intermediate
     256) and perfect (refine_factor 8), each a path of its own; then the
     pair path's line mode over a rebuild with the wide payload, which
     must launch kernel C's wide mode;
  7. SIFT1B_CONFIG at full width over 10M vectors (a cut of SIFT1B's 10^9
     forced by the run time; the fixture scales its clusters with n as
     benchmarks/rehearsal_50m.py does): train on 200k, encode 2M-vector
     chunk files, merge them on the host into a spilled CSR database,
     save it with raw sidecars (adopting the spill files), load it onto
     the card, and serve 1024 queries in batches of 64 through exact and
     refine over vectors_csr, line, query_candidates, BIG line and BIG
     perfect (vectors by id attached on the card); kernel A's merge mode
     must launch; encode, merge, save and load seconds, bin occupancy,
     peak device memory and host RSS are printed;
  8. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}.

Every kernel launch count is reset just before each path (4, 5, the slab
variant of 5, each of 6, and 7's serving) and read just after it; a kernel
of that path with no launch fails the run (`gather_sqdist` on every path
that serves exact, refine or BIG perfect), and so do launch counts or a
recall that differ from the reference run's (REFERENCE_LAUNCHES,
REFERENCE_RECALL).  Recall of every path is checked against an exact
float64 brute force on the card: the SIFT1M paths against their
thresholds (the BIG paths 0.03 below the JAX package's recall on the CPU,
the wide payload's line top-10 at most 0.01 below the compact one's), the
SIFT1B phase against its floors.

Timings are the card's, with its name and power limit printed beside them.
"""

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
# 18, slabs 27 -> 18, BIG 9 -> 0, wide 18 -> 9, SIFT1B 330 -> 165).
LAUNCH_KEYS = ("bitonic_topk", "block_scan", "rerank_fused",
               "segmented_reduce", "lut_gather", "gather_rows",
               "gather_sqdist", "bitonic_topk:sort", "bitonic_topk:select",
               "bitonic_topk:merge", "rerank_fused:wide")
REFERENCE_LAUNCHES = {
    "pair": (108, 73, 36, 140, 0, 36, 18, 45, 63, 0, 0),
    "parts": (108, 108, 18, 90, 108, 18, 18, 81, 27, 0, 0),
    "parts_slabs": (72, 81, 9, 63, 81, 18, 9, 54, 18, 0, 0),
    "big_line": (45, 18, 9, 27, 18, 0, 0, 18, 27, 0, 0),
    "big_perfect": (54, 18, 9, 27, 18, 0, 9, 27, 27, 0, 0),
    "pair_wide": (27, 18, 9, 27, 0, 9, 0, 9, 18, 0, 9),
    "sift1b_build": (0, 0, 0, 310, 0, 0, 0, 0, 0, 0, 0),
    "sift1b": (891, 396, 165, 561, 264, 165, 99, 396, 429, 66, 0),
}
_EXACT_1M = {"R@1": 0.9931640625, "R@10": 0.9931640625,
             "top10_intersection": 0.99345703125}
_REFINE_1M = dict(_EXACT_1M, top10_intersection=0.993359375)
_LINE_1M = {"R@1": 0.1591796875, "R@10": 0.8115234375}


def _modes(**by_mode):
    return {f"{mode}_{key}": v for mode, metrics in by_mode.items()
            for key, v in metrics.items()}


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

N_DB, N_TRAIN, N_QUERIES, BATCH, K = 1_000_000, 200_000, 1024, 256, 100
# The SIFT1B phase: 10M vectors (a cut of SIFT1B's 10^9 forced by the
# smoke's run time) in chunk files of 2M, a tree trained on 200k, 1024
# queries in batches of 64, and its recall floors.
N_1B, N_1B_TRAIN, N_1B_CHUNK, BATCH_1B = 10_000_000, 200_000, 2_000_000, 64
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
    pair_top_m=128, K=1024, k=100, refine k*8=800), then SIFT1B_CONFIG's
    widths (k1_query 16 x c2 16: a 65536-wide pair grid, pair_top_m 256,
    8192 final candidates).  Values are rounded to few levels in half the
    rows, and some slots are +inf, so ties occur."""
    shapes = [("l1_select", 256 * 4, 16, 8),
              ("pair_select", 256 * 2, 128 * 128, 128),
              ("part_sort", 256 * 4, 128, 128),
              ("final_topk", 256, 1024, 100),
              ("refine_line_topk", 256, 1024, 800),
              ("refine_exact_topk", 256, 800, 100),
              ("sift1b_pair_select", 256 * 2, 256 * 256, 256),
              ("sift1b_final_topk", 256, 8192, 100),
              ("sift1b_refine_line_topk", 256, 8192, 800),
              # the BIG path's stage 2 at SIFT1B widths (batch 64, and
              # 256), and the whole 65536-wide row: merge mode
              ("sift1b_big_final_bins", 64, 256 * 256, 32768),
              ("sift1b_big_final_bins_all", 64, 256 * 256, 256 * 256),
              ("sift1b_big_final_bins_b256", 256, 256 * 256, 32768)]
    for name, b, n, k in shapes:
        x = torch.rand((b, n), generator=gen, device="cuda") * 1e4
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


def scan_plans(prim, rows, n):
    """Kernel B's plans, one a mode, for every mode that takes (rows, n)."""
    plans = []
    for mode in ("rows", "onepass"):
        try:
            plans.append(prim._scan_plan(rows, n, mode))
        except NotImplementedError:
            pass
    return plans


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
    enumerated and 768 surviving slots, the 2^20-slot CSR prefix), then
    SIFT1B_CONFIG's (8192 probed bins, 32768 enumerated slots, 2^29 slots).
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
    yield "csr_prefix", (torch.poisson(
        torch.ones(1 << 20, device="cuda"), generator=gen).to(
            torch.int32)[None, :].contiguous(), False), (1, 1 << 20)
    yield "sift1b_candidate_prefix", (capped(8192), False), (b, 8192)
    yield "sift1b_compaction", (flags(32768), True), (b, 32768)
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
RERANK_SHAPES = (
    ("sift1m_line", 1_000_000, 256, 1024, 16, 16, True, 0),
    ("sift1m_line_slabs", 1_000_000, 256, 1024, 16, 16, True, 32),
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
    256); the 2^20-slot occupancy counts and CSR starts; then
    SIFT1B_CONFIG's 2^29-slot (2 GiB) counts at 32768 enumerated bins and
    CSR starts at 8192 probed bins."""
    pair_occ = (torch.rand(2 << 16, generator=gen, device="cuda") < 0.3
                ).to(torch.uint8)
    counts = torch.poisson(torch.ones(1 << 20, device="cuda"),
                           generator=gen).to(torch.int32)
    prefix = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    for name, table, e in (("pair_occ", pair_occ[:1 << 16], 256),
                           ("pair_occ_both_pairs", pair_occ, 2 * 256),
                           ("counts_unfiltered", counts, 2048),
                           ("counts_filtered", counts, 768),
                           ("prefix", prefix, 512)):
        idx = torch.randint(0, table.shape[0], (256, e), generator=gen,
                            device="cuda", dtype=torch.int32)
        yield name, (table.contiguous(), idx), (256, e)
    del pair_occ, counts, prefix
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


def check_kernels(torch):
    from pqt_tpu_torch.ops.cuda import gather as ga
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
        # the mode the wrapper picks, and the other one where it takes the
        # shape: both are held against the plain version, both are timed
        plan = prim._topk_plan(n, k)
        others = [m for m in topk_modes(prim, n, k) if m != plan.mode]
        alt = prim._topk_plan(n, k, others[0]) if others else None
        pv, pi = prim.bitonic_topk_plain(x, k)
        for p in (plan, alt) if alt else (plan,):
            v, i = (prim.bitonic_topk(x, k) if p is plan
                    else prim._topk_launch(x, k, p))
            torch.cuda.synchronize()
            if not (torch.equal(v, pv) and torch.equal(i, pi)):
                bad = int((i != pi).sum())
                raise SmokeFailure(f"bitonic_topk {case} in {p.mode} mode: "
                                   f"{bad} indices differ from the plain "
                                   "version")
        b_ms, b_by = bound(b * n * 4 + b * k * 8, b * n)
        # select mode reads a row longer than one tile again on every pass
        # (so does merge mode's select, for k < n); merge mode then reads
        # and writes its scratch rows of sort_len pairs in the run sorts and
        # in each merge pass (the last one writes k pairs)
        reads = 1.0
        if plan.mode in ("select", "merge") and k < n and \
                n > plan.items * plan.threads:
            reads += float(radix_passes(torch, x, k, prim.TOPK_DIGIT_BITS)
                           .double().mean())
        scratch = 0
        if plan.mode == "merge":
            passes = (plan.sort_len // prim.TOPK_SORT_MAX).bit_length() - 1
            scratch = b * plan.sort_len * 8 * (2 * passes + 2 * int(k < n))
        pass_ms = bound(reads * b * n * 4 + b * k * 8 + scratch, b * n)[0]
        record("bitonic_topk", "pqt_tpu_torch/csrc/topk.cu",
               "pqt_tpu/ops/pallas/primitives.py:79",
               f"{case} ({b},{n})->{k} {plan.mode}",
               device_ms(torch, lambda: prim.bitonic_topk(x, k)),
               device_ms(torch, lambda: prim.bitonic_topk_plain(x, k)),
               device_ms(torch, lambda: torch.topk(x, k, largest=False)),
               b_ms, b_by, 0.0, mode=plan.mode, reads=reads,
               pass_bound_ms=pass_ms, other_mode=alt and alt.mode,
               other_mode_ms=device_ms(
                   torch, lambda: prim._topk_launch(x, k, alt))
               if alt else None,
               sort_ms=device_ms(torch, lambda: torch.sort(x, stable=True))
               if plan.mode == "merge" else None)

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
                   for p in others})
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
    return results, floor


def profile_batch(torch, fn, x, reps=3):
    """Where one batch's time goes: device time by kernel (torch.profiler)
    against the host clock.  Returns a dict, or the reason it could not."""
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        # by the kernel's whole name: PyTorch's elementwise kernels share
        # their first hundred characters whatever operation they run
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
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
    queries and rows, and a position outside the table (NaN)."""
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import primitives as prim
    from pqt_tpu_torch.ops.cuda import rerank as rr

    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, x, k in topk_hard_rows(torch, gen):
        n = x.shape[1]
        want = prim.bitonic_topk_plain(x, k)
        got = {"default": prim.bitonic_topk(x, k)}
        for mode in topk_modes(prim, n, k):
            got[mode] = prim._topk_launch(x, k, prim._topk_plan(n, k, mode))
        for mode, (v, i) in got.items():
            if not (torch.equal(v, want[0]) and torch.equal(i, want[1])):
                raise SmokeFailure(f"bitonic_topk {name} {tuple(x.shape)}->"
                                   f"{k} ({mode} mode) differs")
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
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import primitives as prim
    from pqt_tpu_torch.ops.cuda import rerank as rr
    return (prim.bitonic_topk, prim.block_scan, rr.rerank_fused,
            prim.segmented_reduce, ga.lut_gather, ga.gather_rows,
            prim.gather_sqdist)


def reset_launches(torch):
    torch.cuda.synchronize()
    for c in counters():
        c.launches = 0
    top, rerank = counters()[0], counters()[2]
    top.mode_launches = dict.fromkeys(top.mode_launches, 0)
    rerank.wide_launches = 0


def read_launches(label, required, modes=()):
    """The counts since the last reset, with kernel A's by mode and kernel
    C's wide-layout ones; fails if a kernel of the path, or a mode in
    `modes` ("bitonic_topk:merge", "rerank_fused:wide"), has none."""
    top, rerank = counters()[0], counters()[2]
    launches = {c.__name__: c.launches for c in counters()}
    launches.update({f"bitonic_topk:{m}": n
                     for m, n in top.mode_launches.items()})
    launches["rerank_fused:wide"] = rerank.wide_launches
    print(f"launches on the {label}: " + json.dumps(launches), flush=True)
    for name in tuple(required) + tuple(modes):
        if launches[name] == 0:
            raise SmokeFailure(f"{name} was never launched by the {label}")
    return launches


def differs_from_reference(label, launches, recall=None):
    """What of a path's launch counts (and recall) differs from the
    reference run's; prints the verdict."""
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


def query_modes(P, cfg, tree, db, names):
    modes = {
        "exact": lambda x: P.query_knn(cfg, tree, db, x, K, True),
        "line": lambda x: P.query_knn(cfg, tree, db, x, K),
        "refine": lambda x: P.query_knn_refine(cfg, tree, db, x, K),
        "candidates": lambda x: P.query_candidates(cfg, tree, db, x),
        "big_line": lambda x: P.query_big_knn(cfg, tree, db, x, K, 256),
        "big_perfect": lambda x: P.query_big_knn_perfect(cfg, tree, db, x,
                                                         K, 8, 256),
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
               **info):
    """Serve one path with the launch counts reset just before it and read
    just after it."""
    reset_launches(torch)
    out, lat = serve(torch, modes, qd, batch)
    return dict(launches=read_launches(label, required, need),
                serving=lat, outputs=out, **info)


def query_paths(torch, P):
    from pqt_tpu_torch.ops.distance import brute_force_knn

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
    reset_launches(torch)
    t0 = time.perf_counter()
    tree = P.train_tree(cfg, data[:N_TRAIN], device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
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
    paths = {}
    out, lat = serve(torch, query_modes(P, cfg, tree, db, all_modes), qd)
    paths["pair"] = {"launches": read_launches("pair path",
                                               PAIR_KERNELS + EXACT_KERNELS),
                     "serving": lat, "outputs": out, "cfg": cfg, "db": db,
                     "reference": (ROUND5, "round 5")}

    # phase 5: the parts path, then its slab-gather variant
    paths["parts"] = serve_path(
        torch, "parts path", query_modes(P, parts_cfg, tree, db, all_modes),
        qd, PARTS_KERNELS + EXACT_KERNELS, cfg=parts_cfg, db=db,
        reference=(JAX_CPU_PARTS, "JAX on the CPU"))
    paths["parts_slabs"] = serve_path(
        torch, "parts path with slab gathers",
        query_modes(P, slabs_cfg, tree, db, ("exact", "line", "candidates")),
        qd, PARTS_KERNELS + EXACT_KERNELS, cfg=slabs_cfg, db=db,
        reference=(JAX_CPU_SLABS, "JAX on the CPU"))

    # phase 6: the BIG two-stage path, line and perfect, on the same
    # database; then the pair path's line mode over the wide payload
    for name in ("big_line", "big_perfect"):
        paths[name] = serve_path(
            torch, f"BIG path ({name[4:]})",
            query_modes(P, cfg, tree, db, (name,)), qd,
            BIG_KERNELS + (EXACT_KERNELS if name == "big_perfect" else ()),
            cfg=cfg, db=db, reference=(JAX_CPU_BIG, "JAX on the CPU"))
    wide_db = P.build_database(wide_cfg, tree, data, device="cuda")
    paths["pair_wide"] = serve_path(
        torch, "pair path over the wide payload",
        query_modes(P, wide_cfg, tree, wide_db, ("line",)), qd,
        PAIR_KERNELS, ("rerank_fused:wide",), cfg=wide_cfg, db=wide_db,
        reference=({}, "compact payload"))

    _, gt = brute_force_knn(qd, torch.as_tensor(data, device="cuda"), K)
    gt = gt.cpu().numpy()
    failed, changed = [], []
    summary = {"train_s": train_s, "build_s": build_s, "paths": {}}
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
        profiles = {m: profile_batch(
            torch, query_modes(P, c, tree, path["db"], (m,))[m], qd[:BATCH])
            for m in path["serving"] if m in ("exact", "line", "big_line",
                                              "big_perfect")}
        for m, pr in profiles.items():
            print(f"profile {label} {m}: " + json.dumps(pr), flush=True)
        summary["paths"][label] = {
            "pipeline": c.pipeline, "pair_filter": c.pair_filter,
            "gather_mode": c.gather_mode,
            "payload_compact": c.payload_compact,
            "launches": path["launches"],
            "serving": path["serving"], "recall": metrics,
            "profiles": profiles}
    if failed:
        raise SmokeFailure(f"recall below threshold: {failed}")
    if changed:
        raise SmokeFailure(f"launch counts or recall differ from the "
                           f"reference run's: {changed}")
    return summary


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


def sift1b_phase(torch, P, workdir):
    """SIFT1B_CONFIG at full width over 10M vectors, out of core: chunk
    files, host merge with the spill, sidecar save, load onto the card;
    then exact and refine through vectors_csr, line, candidates, BIG line
    and BIG perfect at batch 64."""
    from pqt_tpu_torch.io import native
    from pqt_tpu_torch.ops.distance import brute_force_knn

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
    torch.cuda.reset_peak_memory_stats()
    times = {}
    t_phase = t0 = time.perf_counter()
    _, draw = sift1b_fixture(torch, N_1B)
    data = torch.empty((N_1B, 128), dtype=torch.uint8, device="cuda")
    for s in range(0, N_1B, N_1B_CHUNK):
        data[s:s + N_1B_CHUNK] = draw(min(N_1B_CHUNK, N_1B - s))
    qd = draw(N_QUERIES).to(torch.float32)
    torch.cuda.synchronize()
    times["fixture_s"] = time.perf_counter() - t0

    reset_launches(torch)
    t0 = time.perf_counter()
    tree = P.train_tree(cfg, data[:N_1B_TRAIN], device="cuda")
    torch.cuda.synchronize()
    times["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paths = []
    for i, s in enumerate(range(0, N_1B, N_1B_CHUNK)):
        paths.append(os.path.join(workdir, f"chunk{i}.npz"))
        P.encode_chunk_to_file(cfg, tree, data[s:s + N_1B_CHUNK].cpu().numpy(),
                               s, paths[-1], keep_vectors=True,
                               device="cuda")
    times["encode_s"] = time.perf_counter() - t0
    # the encode's per-part norms (kernel D); k1_build = c1 asks for no top-k
    build_launches = read_launches("SIFT1B train and encode",
                                   ("segmented_reduce",))
    t0 = time.perf_counter()
    host_db = P.merge_chunk_files(cfg, tree, paths, keep_vectors=True,
                                  spill_path=os.path.join(workdir, "spill"),
                                  to_device=False)
    times["merge_s"] = time.perf_counter() - t0
    for path in paths:
        os.remove(path)
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

    loaded_gib = torch.cuda.memory_allocated() / 2 ** 30
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    modes = query_modes(P, cfg, tree, db, ("exact", "line", "refine",
                                           "candidates", "big_line"))
    # BIG perfect re-ranks by id: the vectors by id, attached on the card
    by_id = db._replace(vectors=data)
    modes.update(query_modes(P, cfg, tree, by_id, ("big_perfect",)))
    path = serve_path(torch, "SIFT1B phase", modes, qd,
                      ALL_KERNELS + EXACT_KERNELS, ("bitonic_topk:merge",),
                      batch=BATCH_1B)
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
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
    profiles = {m: profile_batch(torch, modes[m], qd[:BATCH_1B])
                for m in ("exact", "big_line")}
    for m, pr in profiles.items():
        print(f"profile sift1b {m}: " + json.dumps(pr), flush=True)
    peak = max(load_peak, serve_peak,
               torch.cuda.max_memory_allocated() / 2 ** 30)
    rss = host_rss_gib()
    times["phase_s"] = time.perf_counter() - t_phase
    print(f"sift1b: {times['phase_s']:.1f} s in all, peak device memory "
          f"{peak:.2f} GiB (with the float64 oracle), host RSS "
          f"{rss[0]:.2f} GiB (peak {rss[1]:.2f})", flush=True)
    if failed:
        raise SmokeFailure(f"sift1b recall below its floor: {failed}")
    if changed:
        raise SmokeFailure(f"sift1b launch counts or recall differ from "
                           f"the reference run's: {changed}")
    return {"n": N_1B, "cut": "10M of SIFT1B's 10^9 (the smoke's run time)",
            "times": times, "nonempty_bins": nonempty, "largest_bin": largest,
            "peak_device_gib": peak, "loaded_device_gib": loaded_gib,
            "serving_peak_device_gib": serve_peak, "host_rss_gib": rss[0],
            "host_peak_rss_gib": rss[1], "build_launches": build_launches,
            "launches": path["launches"], "serving": path["serving"],
            "recall": metrics, "floors": floors, "profiles": profiles}


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
            if c.get("other_mode"):
                other += f"  {c['other_mode']} mode {c['other_mode_ms']:.4f}"
            for mode, ms in c.get("other_modes", {}).items():
                other += f"  {mode} mode {ms:.4f}"
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
          "re-ranks in every mode and copy unit): equal to their plain "
          "versions", flush=True)

    summary = query_paths(torch, P)
    peak_before = torch.cuda.max_memory_allocated()
    with tempfile.TemporaryDirectory(prefix="pqt_sift1b_") as workdir:
        summary["sift1b"] = sift1b_phase(torch, P, workdir)
    runs = [p["launches"] for p in summary["paths"].values()] + [
        summary["sift1b"]["build_launches"], summary["sift1b"]["launches"]]
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
