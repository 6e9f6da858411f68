#!/usr/bin/env python3
"""Drive the PyTorch port (pqt_tpu_torch) on one CUDA card, end to end.

Run from the repository root:  python3 chip_smoke.py [--json PATH]

Phases (any failure exits non-zero before the last line is printed):

  1. preconditions: a CUDA card; prints nvidia-smi's name and power limit
     and the TF32 flags the package sets;
  2. builds the hand-written CUDA kernels from pqt_tpu_torch/csrc (nvcc,
     one process per source, in parallel) and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes the query paths give it (top-k, prefix sums, lookups and
     row gathers exact; line re-rank within rtol 1e-5, atol 1e-4; segment
     sums within rtol 1e-5, atol 1e-3), and times kernel, plain version and
     the one PyTorch call computing the same function by their device time
     (torch.profiler);
  4. the pair path at SIFT1M width: train a tree on 200k of bench.py's 1M
     SIFT-like vectors (seed 0), build the database of all 1M on the card
     (with the pair-occupancy table, which the pair path leaves unused),
     and serve 1024 held-out queries in batches of 256 through exact, line
     and refine query_knn and query_candidates;
  5. the parts path on the same tree and database: the parts pipeline with
     the pair filter through the same four entry points, then exact, line
     and query_candidates again with slab gathers (32 rows a slab);
  6. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}.

Every kernel launch count is reset just before each path (4, 5, and the
slab variant of 5) and read just after it; a kernel of that path with no
launch fails the run.  Recall of every path is checked against an exact
float64 brute force on the card.

Timings are the card's, with its name and power limit printed beside them.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s, for each kernel's least possible time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# Round-5 recall of the JAX package on the same fixture and budget
# (BENCH_r05.json); recall depends on the algorithm, not on the chip.
ROUND5 = {"exact_R@1": 0.9854, "refine_R@1": 0.9854,
          "candidate_recall": 0.9863, "line_top10_intersection": 0.7188}
THRESHOLDS = {"exact_R@1": 0.95, "refine_R@1": 0.95,
              "candidate_recall": 0.95, "line_top10_intersection": 0.6}
# The JAX package's recall on the CPU for the same fixture, tree training
# and budget, with the parts pipeline and the pair filter (slack 1.5), in
# rows and in slab mode (refine was not run there).
JAX_CPU_PARTS = {"exact_R@1": 0.9893, "candidate_recall": 0.9893,
                 "line_top10_intersection": 0.7206}
JAX_CPU_SLABS = {"exact_R@1": 0.9893, "candidate_recall": 0.9893,
                 "line_top10_intersection": 0.7203}
# The kernels of each path: a count of 0 on its run fails the smoke.
PAIR_KERNELS = ("bitonic_topk", "block_scan", "rerank_fused",
                "segmented_reduce", "gather_rows")
PARTS_KERNELS = PAIR_KERNELS + ("lut_gather",)

N_DB, N_TRAIN, N_QUERIES, BATCH, K = 1_000_000, 200_000, 1024, 256, 100


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


def device_ms(torch, fn, reps=20, warmup=3, attempts=3):
    """Mean milliseconds the card spends in the kernels fn() launches, from
    the profiler's device events: a run of launches timed with CUDA events
    would measure the host's launch rate for kernels this short.  Now and
    then a profiler session records no device events at all; the session
    is then repeated, up to `attempts` times.  0.0 when none recorded any."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    return 0.0


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
    pair_top_m=128, K=1024, k=100, refine k*8=800).  Values are rounded to
    few levels in half the rows, and some slots are +inf, so ties occur."""
    shapes = [("l1_select", 256 * 4, 16, 8),
              ("pair_select", 256 * 2, 128 * 128, 128),
              ("part_sort", 256 * 4, 128, 128),
              ("final_topk", 256, 1024, 100),
              ("refine_line_topk", 256, 1024, 800),
              ("refine_exact_topk", 256, 800, 100)]
    for name, b, n, k in shapes:
        x = torch.rand((b, n), generator=gen, device="cuda") * 1e4
        x[: b // 2] = torch.round(x[: b // 2] / 1e3)
        x[torch.rand((b, n), generator=gen, device="cuda") < 0.05] = \
            float("inf")
        yield name, (x.contiguous(), k), (b, n, k)


def scan_cases(torch, gen):
    b, nb = 256, 512
    capped = torch.randint(0, 1025, (b, nb), generator=gen, device="cuda",
                           dtype=torch.int32)
    flags = torch.randint(0, 2, (b, nb), generator=gen, device="cuda",
                          dtype=torch.int32)
    counts = torch.poisson(torch.ones(1 << 20, device="cuda"),
                           generator=gen).to(torch.int32)[None, :]
    yield "candidate_prefix", (capped, False), (b, nb)
    yield "probe_compaction", (flags, True), (b, nb)
    for name, e in (("filter_compaction", 2048), ("survivor_compaction",
                                                   768)):
        f = torch.randint(0, 2, (b, e), generator=gen, device="cuda",
                          dtype=torch.int32)
        yield name, (f, True), (b, e)
    yield "csr_prefix", (counts.contiguous(), False), (1, 1 << 20)


def rerank_cases(torch, gen):
    b, k, lp, c1 = 256, 1024, 16, 16
    # compact line parts A | B << 4 | lambda_u8 << 8, two to an int32 word,
    # with lambda in [-0.5, 1.5) as the build gives it: a projection inside
    # or near its segment (lambda_u8 = (lambda + 4) * 32)
    ab = torch.randint(0, 256, (b, k, lp), generator=gen, device="cuda")
    lam8 = torch.randint(112, 176, (b, k, lp), generator=gen, device="cuda")
    half = ab | (lam8 << 8)
    words = half[..., 0::2] | (half[..., 1::2] << 16)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    t3 = torch.randn((b, k, 1), generator=gen, device="cuda")
    ids = torch.arange(k, device="cuda", dtype=torch.int32).expand(b, k)
    rows = torch.cat([ids[..., None], t3.view(torch.int32),
                      words.to(torch.int32)], dim=-1).contiguous()
    q = (torch.rand((b, lp, c1), generator=gen, device="cuda") * 5e3)
    yield "line_rerank", (rows, q.contiguous()), (b, k, 2 + lp // 2, lp, c1)


def reduce_cases(torch, gen):
    """Squares of uint8-range values (query components, or differences of
    uint8 vectors and queries), as the distance tables' per-part norms
    (p = 4, line_parts = 16) and the exact re-rank's row sums give them."""
    for name, rows, d, parts in (("part_norms", 256, 128, 4),
                                 ("line_part_norms", 256, 128, 16),
                                 ("exact_row_sums", 256 * 1024, 128, 1)):
        v = torch.randint(-255, 256, (rows, d), generator=gen,
                          device="cuda").to(torch.float32)
        yield name, ((v * v).contiguous(), parts), (rows, d, parts)


def lut_cases(torch, gen):
    """The lookups of the parts path at batch 256 (p = 4, base 16, 2048
    enumerated bins, 768 filter survivors, 512 probed bins): the uint8 pair
    table of one pair, the 2^20-slot occupancy counts and CSR starts."""
    pair_occ = (torch.rand(1 << 16, generator=gen, device="cuda") < 0.3
                ).to(torch.uint8)
    counts = torch.poisson(torch.ones(1 << 20, device="cuda"),
                           generator=gen).to(torch.int32)
    prefix = (torch.cumsum(counts, 0, dtype=torch.int32) - counts)
    for name, table, e in (("pair_occ", pair_occ, 256),
                           ("counts_unfiltered", counts, 2048),
                           ("counts_filtered", counts, 768),
                           ("prefix", prefix, 512)):
        idx = torch.randint(0, table.shape[0], (256, e), generator=gen,
                            device="cuda", dtype=torch.int32)
        yield name, (table.contiguous(), idx), (256, e)


def gather_cases(torch, gen):
    """The row gathers of both paths at batch 256: compact payload rows (1M
    x 10 int32) for 1024 candidates, in rows mode and as 32 slabs of 32
    rows; uint8 vectors (1M x 128) for 1024 exact and 800 refine
    candidates; the (start, end) extent rows of 512 probed bins."""
    n = 1_000_000
    payload = torch.randint(-(1 << 30), 1 << 30, (n, 10), generator=gen,
                            device="cuda", dtype=torch.int32)
    vectors = torch.randint(0, 256, (n, 128), generator=gen, device="cuda",
                            dtype=torch.uint8)
    prefix2 = torch.randint(0, n, (1 << 20, 2), generator=gen, device="cuda",
                            dtype=torch.int32)
    for name, tab, k, span in (("payload_rows", payload, 1024, 1),
                               ("payload_slabs", payload, 32, 32),
                               ("vectors_exact", vectors, 1024, 1),
                               ("vectors_refine", vectors, 800, 1),
                               ("extent_rows", prefix2, 512, 1)):
        pos = torch.randint(0, tab.shape[0] - span + 1, (256, k),
                            generator=gen, device="cuda", dtype=torch.int32)
        yield name, (tab, pos, span), (256, k, span)


def check_kernels(torch):
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import primitives as prim
    from pqt_tpu_torch.ops.cuda import rerank as rr

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    # the first profiler session of a process may record no device events
    device_ms(torch, lambda: torch.ones(8, device="cuda") + 1, reps=1)

    def record(name, route_src, replaces, case, ms, plain_ms, lib_ms, b_ms,
               b_by, err):
        """Add one shape's numbers; a kernel's totals sum its shapes."""
        if ms <= 0 or plain_ms <= 0 or (lib_ms is not None and lib_ms <= 0):
            raise SmokeFailure(f"{name} {case}: no profiler session recorded "
                               "device time")
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
                            "bound_by": b_by, "max_abs_err": err})

    for case, (x, k), (b, n, _) in topk_cases(torch, gen):
        v, i = prim.bitonic_topk(x, k)
        pv, pi = prim.bitonic_topk_plain(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(v, pv) and torch.equal(i, pi)):
            bad = int((i != pi).sum())
            raise SmokeFailure(f"bitonic_topk {case}: {bad} indices differ "
                               "from the plain version")
        b_ms, b_by = bound(b * n * 4 + b * k * 8, b * n)
        record("bitonic_topk", "pqt_tpu_torch/csrc/topk.cu",
               "pqt_tpu/ops/pallas/primitives.py:79", f"{case} ({b},{n})->{k}",
               device_ms(torch, lambda: prim.bitonic_topk(x, k)),
               device_ms(torch, lambda: prim.bitonic_topk_plain(x, k)),
               device_ms(torch, lambda: torch.topk(x, k, largest=False)),
               b_ms, b_by, 0.0)

    for case, (x, excl), (b, n) in scan_cases(torch, gen):
        got = prim.block_scan(x, excl)
        want = prim.block_scan_plain(x, excl)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SmokeFailure(f"block_scan {case}: differs from the plain "
                               "version")
        b_ms, b_by = bound(2 * b * n * 4, b * n)
        record("block_scan", "pqt_tpu_torch/csrc/scan.cu",
               "pqt_tpu/ops/pallas/primitives.py:115",
               f"{case} ({b},{n}) {'exclusive' if excl else 'inclusive'}",
               device_ms(torch, lambda: prim.block_scan(x, excl)),
               device_ms(torch, lambda: prim.block_scan_plain(x, excl)),
               device_ms(torch,
                         lambda: torch.cumsum(x, -1, dtype=torch.int32)),
               b_ms, b_by, 0.0)

    for case, (rows, q), (b, k, w, lp, c1) in rerank_cases(torch, gen):
        got = rr.rerank_fused(rows, q)
        want = rr.rerank_plain(rows, q)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise SmokeFailure(f"rerank_fused {case}: max abs error {err}")
        b_ms, b_by = bound(b * k * w * 4 + b * lp * c1 * 4 + b * k * 4,
                           4 * b * k * lp)
        record("rerank_fused", "pqt_tpu_torch/csrc/rerank.cu",
               "pqt_tpu/ops/pallas/rerank.py:84", f"{case} ({b},{k},{w})",
               device_ms(torch, lambda: rr.rerank_fused(rows, q)),
               device_ms(torch, lambda: rr.rerank_plain(rows, q)),
               None, b_ms, b_by, err)

    for case, (x, parts), (b, d, _) in reduce_cases(torch, gen):
        got = prim.segmented_reduce(x, parts)
        want = prim.segmented_reduce_plain(x, parts)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # sums of up to 128 squares below 2^16, added in another order
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-3):
            raise SmokeFailure(f"segmented_reduce {case}: max abs error {err}")
        b_ms, b_by = bound(b * d * 4 + b * parts * 4, b * d)
        record("segmented_reduce", "pqt_tpu_torch/csrc/reduce.cu",
               "pqt_tpu/ops/pallas/primitives.py:145",
               f"{case} ({b},{d})->{parts}",
               device_ms(torch, lambda: prim.segmented_reduce(x, parts)),
               device_ms(torch, lambda: prim.segmented_reduce_plain(x, parts)),
               device_ms(torch, lambda: x.view(b, parts, d // parts).sum(-1)),
               b_ms, b_by, err)

    for case, (table, idx), (b, e) in lut_cases(torch, gen):
        got = ga.lut_gather(table, idx)
        want = ga.lut_gather_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SmokeFailure(f"lut_gather {case}: differs from the plain "
                               "version")
        es = table.element_size()
        touched = int(torch.unique(idx).numel())
        b_ms, b_by = bound(b * e * 4 + b * e * es + touched * es, 0)
        record("lut_gather", "pqt_tpu_torch/csrc/lut.cu",
               "benchmarks/micro_gather.py:32",
               f"{case} ({table.shape[0]},) {table.dtype} at ({b},{e})",
               device_ms(torch, lambda: ga.lut_gather(table, idx)),
               device_ms(torch, lambda: ga.lut_gather_plain(table, idx)),
               device_ms(torch, lambda: table[idx]), b_ms, b_by, 0.0)

    for case, (tab, pos, span), (b, k, _) in gather_cases(torch, gen):
        got = ga.gather_rows(tab, pos, span)
        want = ga.gather_rows_plain(tab, pos, span)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SmokeFailure(f"gather_rows {case}: differs from the plain "
                               "version")
        row_bytes = tab.shape[1] * tab.element_size()
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
               f"({b},{k}) span {span}",
               device_ms(torch, lambda: ga.gather_rows(tab, pos, span)),
               device_ms(torch, lambda: ga.gather_rows_plain(tab, pos, span)),
               device_ms(torch, lambda: tab[full]), b_ms, b_by, 0.0)
    return results


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
        kernels = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name[:60]
                kernels[name] = kernels.get(name, 0.0) + (
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
            "top_kernels_ms": [[k, v] for k, v in top]}


def check_other_paths(torch):
    """Kernel paths beyond the query paths' shapes, for correctness only
    (not timed): a tiny top-k row, several long rows and ragged widths of
    the scan (the long-row mode serves hash tables up to 2^29 slots),
    segments shorter than a warp and of odd lengths, lookups of a ragged
    shape from an odd-sized table, and row gathers in every copy unit (rows
    of 3, 6 and 12 bytes, a table that starts off a 16-byte boundary, a
    span of 5)."""
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import primitives as prim

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.round(torch.rand((5, 3), generator=gen, device="cuda") * 50)
    if not all(torch.equal(u, v) for u, v in zip(
            prim.bitonic_topk(x, 3), prim.bitonic_topk_plain(x, 3))):
        raise SmokeFailure("bitonic_topk (5,3)->3 differs")
    for b, n in ((4, 100_003), (3, 5000), (2, 31)):
        x = torch.randint(0, 9, (b, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        for excl in (False, True):
            if not torch.equal(prim.block_scan(x, excl),
                               prim.block_scan_plain(x, excl)):
                raise SmokeFailure(f"block_scan ({b},{n}) differs")
    for b, d, parts in ((5, 21, 3), (3, 3, 3), (2, 1000, 1), (7, 48, 3)):
        x = torch.randint(0, 9, (b, d), generator=gen,
                          device="cuda").to(torch.float32)
        if not torch.equal(prim.segmented_reduce(x, parts),
                           prim.segmented_reduce_plain(x, parts)):
            raise SmokeFailure(f"segmented_reduce ({b},{d})->{parts} "
                               "differs")
    idx = torch.randint(0, 1001, (3, 77), generator=gen, device="cuda",
                        dtype=torch.int32)
    for dtype in (torch.int32, torch.uint8):
        table = torch.randint(0, 99, (1001,), generator=gen,
                              device="cuda").to(dtype)
        if not torch.equal(ga.lut_gather(table, idx),
                           ga.lut_gather_plain(table, idx)):
            raise SmokeFailure(f"lut_gather {dtype} (3,77) differs")
    for dtype, w, offset, span in ((torch.uint8, 3, 0, 1),
                                   (torch.int16, 3, 0, 5),
                                   (torch.int32, 3, 0, 2),
                                   (torch.int32, 10, 1, 1)):
        tab = torch.randint(-99, 99, (500, w), generator=gen,
                            device="cuda").to(dtype)[offset:]
        pos = torch.randint(0, tab.shape[0] - span + 1, (4, 9),
                            generator=gen, device="cuda", dtype=torch.int32)
        if not torch.equal(ga.gather_rows(tab, pos, span),
                           ga.gather_rows_plain(tab, pos, span)):
            raise SmokeFailure(f"gather_rows {dtype} width {w} offset "
                               f"{offset} span {span} differs")
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
            prim.segmented_reduce, ga.lut_gather, ga.gather_rows)


def reset_launches(torch):
    torch.cuda.synchronize()
    for c in counters():
        c.launches = 0


def read_launches(label, required):
    """The counts since the last reset; fails if a kernel of the path has
    none."""
    launches = {c.__name__: c.launches for c in counters()}
    print(f"launches on the {label}: " + json.dumps(launches), flush=True)
    for name in required:
        if launches[name] == 0:
            raise SmokeFailure(f"{name} was never launched by the {label}")
    return launches


def query_modes(P, cfg, tree, db, names):
    modes = {
        "exact": lambda x: P.query_knn(cfg, tree, db, x, K, True),
        "line": lambda x: P.query_knn(cfg, tree, db, x, K),
        "refine": lambda x: P.query_knn_refine(cfg, tree, db, x, K),
        "candidates": lambda x: P.query_candidates(cfg, tree, db, x),
    }
    return {n: modes[n] for n in names}


def serve(torch, modes, qd):
    """Every mode over the queries twice, in batches, after one warm-up
    batch.  QPS is every query of the window over the window's whole time,
    so a stall inside it counts; per-batch percentiles are reported beside
    it.  Returns (the first pass's outputs, latency) by mode."""
    outputs, latency = {}, {}
    for name, fn in modes.items():
        fn(qd[:BATCH])                        # warm-up
        samples, outs = [], []
        torch.cuda.synchronize()
        t_window = time.perf_counter()
        for rep in range(2):
            for s in range(0, N_QUERIES, BATCH):
                t1 = time.perf_counter()
                out = fn(qd[s:s + BATCH])
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t1)
                if rep == 0:
                    outs.append(out)
        window_s = time.perf_counter() - t_window
        outputs[name] = outs
        latency[name] = {"qps": 2 * N_QUERIES / window_s,
                         "p50_ms": float(np.percentile(samples, 50)) * 1e3,
                         "p90_ms": float(np.percentile(samples, 90)) * 1e3,
                         "max_ms": max(samples) * 1e3,
                         "batch_ms": [t * 1e3 for t in samples]}
    return outputs, latency


def path_recall(torch, label, outputs, gt):
    """Recall of the modes a path served, against the exact neighbours."""
    from pqt_tpu_torch.utils.metrics import (candidate_recall,
                                             intersection_at, recall_at)
    got, metrics = {}, {}
    for name in ("exact", "line", "refine"):
        if name not in outputs:
            continue
        ids = torch.cat([o.indices for o in outputs[name]]).cpu().numpy()
        dists = torch.cat([o.dists for o in outputs[name]]).cpu().numpy()
        if ids.shape != (N_QUERIES, K) or not np.isfinite(
                dists[ids >= 0]).all():
            raise SmokeFailure(f"{label} {name}: bad result shape or "
                               "distances")
        got[name] = ids
    if "exact" in got:
        metrics["exact_R@1"] = recall_at(got["exact"], gt, (1,))["R@1"]
        metrics["exact_top10_intersection"] = intersection_at(
            got["exact"], gt, (10,))["top10_intersection"]
    if "refine" in got:
        metrics["refine_R@1"] = recall_at(got["refine"], gt, (1,))["R@1"]
    if "line" in got:
        metrics["line_top10_intersection"] = intersection_at(
            got["line"], gt, (10,))["top10_intersection"]
        metrics["line_R@1"] = recall_at(got["line"], gt, (1,))["R@1"]
    if "candidates" in outputs:
        cand = torch.cat([o[0] for o in outputs["candidates"]]).cpu().numpy()
        valid = torch.cat([o[1] for o in outputs["candidates"]]).cpu().numpy()
        metrics["candidate_recall"] = candidate_recall(cand, valid, gt)
    return metrics


def report(label, metrics, latency, reference, ref_name):
    """Print a path's recall beside its limits and reference, and its
    serving numbers; returns the metrics below their limits."""
    print(f"-- {label}", flush=True)
    for key, lim in THRESHOLDS.items():
        if key in metrics:
            print(f"{key:26s} {metrics[key]:.4f}  (threshold {lim}, "
                  f"{ref_name} {reference.get(key, 'not run')})", flush=True)
    for name, lat in latency.items():
        print(f"{name:10s} QPS {lat['qps']:.0f} ({2 * N_QUERIES} queries in "
              f"batches of {BATCH})  batch latency p50 {lat['p50_ms']:.3f} "
              f"p90 {lat['p90_ms']:.3f} max {lat['max_ms']:.3f} ms",
              flush=True)
    return [f"{label} {k}" for k, lim in THRESHOLDS.items()
            if k in metrics and metrics[k] < lim]


def query_paths(torch, P):
    from pqt_tpu_torch.ops.distance import brute_force_knn

    # the pair path's cfg leaves the pair filter off, as bench.py does
    cfg = P.SIFT1M_CONFIG.replace(
        kmeans_iters=8, train_subsample=100_000, hash_size=1 << 20,
        max_bins=512, max_candidates=1024, pair_top_m=128, enum_width=512,
        pair_filter=False)
    parts_cfg = cfg.replace(pipeline="parts", pair_filter=True)
    slabs_cfg = parts_cfg.replace(gather_mode="slabs", slab_size=32)
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
    paths["pair"] = {"launches": read_launches("pair path", PAIR_KERNELS),
                     "serving": lat, "outputs": out, "cfg": cfg,
                     "reference": (ROUND5, "round 5")}

    # phase 5: the parts path, then its slab-gather variant
    reset_launches(torch)
    out, lat = serve(torch, query_modes(P, parts_cfg, tree, db, all_modes),
                     qd)
    paths["parts"] = {"launches": read_launches("parts path", PARTS_KERNELS),
                      "serving": lat, "outputs": out, "cfg": parts_cfg,
                      "reference": (JAX_CPU_PARTS, "JAX on the CPU")}
    reset_launches(torch)
    out, lat = serve(torch, query_modes(P, slabs_cfg, tree, db,
                                        ("exact", "line", "candidates")), qd)
    paths["parts_slabs"] = {
        "launches": read_launches("parts path with slab gathers",
                                  PARTS_KERNELS),
        "serving": lat, "outputs": out, "cfg": slabs_cfg,
        "reference": (JAX_CPU_SLABS, "JAX on the CPU")}

    _, gt = brute_force_knn(qd, torch.as_tensor(data, device="cuda"), K)
    gt = gt.cpu().numpy()
    failed, summary = [], {"train_s": train_s, "build_s": build_s,
                           "paths": {}}
    for label, path in paths.items():
        c = path["cfg"]
        metrics = path_recall(torch, label, path["outputs"], gt)
        failed += report(label, metrics, path["serving"], *path["reference"])
        profiles = {m: profile_batch(
            torch, query_modes(P, c, tree, db, (m,))[m], qd[:BATCH])
            for m in ("exact", "line")}
        for m, pr in profiles.items():
            print(f"profile {label} {m}: " + json.dumps(pr), flush=True)
        summary["paths"][label] = {
            "pipeline": c.pipeline, "pair_filter": c.pair_filter,
            "gather_mode": c.gather_mode, "launches": path["launches"],
            "serving": path["serving"], "recall": metrics,
            "profiles": profiles}
    if failed:
        raise SmokeFailure(f"recall below threshold: {failed}")
    launches = {c.__name__: sum(p["launches"][c.__name__]
                                for p in paths.values())
                for c in counters()}
    return launches, summary


# kernel E/F/G rows: one CUDA kernel stands for the three TPU lookups
LUT_ROWS = (("lut_gather", "benchmarks/micro_gather.py:32"),
            ("lut_gather:lut_2d", "benchmarks/micro_gather2.py:39"),
            ("lut_gather:lut_onehot", "benchmarks/micro_gather2.py:69"))


def main(json_path=None):
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
    nvcc_s = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {nvcc_s:.2f} s)", flush=True)

    kernels = check_kernels(torch)
    for r in kernels.values():
        print(f"{r['name']:16s} ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {r['library_ms']}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})  max_abs_err {r['max_abs_err']}", flush=True)
        for c in r["shapes"]:
            print(f"    {c['case']:56s} ms {c['ms']:.4f}  plain "
                  f"{c['plain_ms']:.4f}  library {c['library_ms']}  bound "
                  f"{c['bound_ms']:.4f}", flush=True)

    check_other_paths(torch)
    print("other kernel paths (tiny top-k row, multi-row long scans, ragged "
          "scan widths, short and odd segments, ragged lookups, every "
          "row-copy unit): equal to their plain versions", flush=True)

    launches, summary = query_paths(torch, P)
    rows = []
    for r in kernels.values():
        r["launches"] = launches[r["name"]]
        if r["name"] != "lut_gather":
            rows.append(r)
            continue
        rows += [dict(r, name=name, replaces=where)
                 for name, where in LUT_ROWS]
    summary["card"] = card
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
