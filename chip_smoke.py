#!/usr/bin/env python3
"""Drive the PyTorch port (pqt_tpu_torch) on one CUDA card, end to end.

Run from the repository root:  python3 chip_smoke.py [--json PATH]

Phases (any failure exits non-zero before the last line is printed):

  1. preconditions: a CUDA card; prints nvidia-smi's name and power limit
     and the TF32 flags the package sets;
  2. builds the hand-written CUDA kernels from pqt_tpu_torch/csrc (nvcc,
     one process per source, in parallel) and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card, at
     the shapes the main path gives it (top-k and prefix sums exact; line
     re-rank within rtol 1e-5, atol 1e-4), and times kernel, plain version
     and the one PyTorch call computing the same function by their device
     time (torch.profiler);
  4. the main path at SIFT1M width: train a tree on 200k of bench.py's 1M
     SIFT-like vectors (seed 0), build the database of all 1M on the card,
     and serve 1024 held-out queries in batches of 256 through exact, line
     and refine query_knn and query_candidates, with every kernel launch
     count reset just before and read just after; recall is checked against
     an exact float64 brute force on the card;
  5. one JSON line of per-kernel results, the card line, and last
     {"ok": true, "device": {...}}.

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
    """The main path's top-k shapes at batch 256 (p=4, c1=16, W=8, L=128,
    pair_top_m=128, K=1024, k=100, refine k*8=800).  Values are rounded to
    few levels in half the rows, and some slots are +inf, so ties occur."""
    shapes = [("l1_select", 256 * 4, 16, 8),
              ("pair_select", 256 * 2, 128 * 128, 128),
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


def check_kernels(torch):
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
    """Kernel paths beyond the main path's shapes, for correctness only
    (not timed): a tiny top-k row, several long rows and ragged widths of
    the scan (the long-row mode serves hash tables up to 2^29 slots)."""
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
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def main_path(torch, P):
    from pqt_tpu_torch.ops.cuda import primitives as prim
    from pqt_tpu_torch.ops.cuda import rerank as rr
    from pqt_tpu_torch.ops.distance import brute_force_knn
    from pqt_tpu_torch.utils.metrics import (candidate_recall,
                                             intersection_at, recall_at)

    cfg = P.SIFT1M_CONFIG.replace(
        kmeans_iters=8, train_subsample=100_000, hash_size=1 << 20,
        max_bins=512, max_candidates=1024, pair_top_m=128, enum_width=512,
        pair_filter=False)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    data, subcenters = make_sift_like(N_DB, cfg.dim, rng)
    queries = make_queries(N_QUERIES, subcenters, rng)
    print(f"fixture: {N_DB} x {cfg.dim} uint8, {N_QUERIES} queries "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    counters = (prim.bitonic_topk, prim.block_scan, rr.rerank_fused)

    for c in counters:                       # main path starts here
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = P.train_tree(cfg, data[:N_TRAIN], device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db = P.build_database(cfg, tree, data, keep_vectors=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    print(f"train_s {train_s:.2f}  build_s {build_s:.2f}  "
          f"(non-empty bins {int((db.counts > 0).sum())})", flush=True)

    qd = torch.as_tensor(queries, device="cuda")
    modes = {
        "exact": lambda x: P.query_knn(cfg, tree, db, x, K, True),
        "line": lambda x: P.query_knn(cfg, tree, db, x, K),
        "refine": lambda x: P.query_knn_refine(cfg, tree, db, x, K),
        "candidates": lambda x: P.query_candidates(cfg, tree, db, x),
    }
    # QPS is every query of the window over the window's whole time, so a
    # stall inside it counts; per-batch percentiles are reported beside it.
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
    launches = {c.__name__: c.launches for c in counters}   # main path ends
    print("launches on the main path: " + json.dumps(launches), flush=True)
    for name, n in launches.items():
        if n == 0:
            raise SmokeFailure(f"{name} was never launched by the main path")

    profiles = {m: profile_batch(torch, modes[m], qd[:BATCH])
                for m in ("exact", "line")}
    for m, pr in profiles.items():
        print(f"profile {m}: " + json.dumps(pr), flush=True)

    _, gt = brute_force_knn(qd, torch.as_tensor(data, device="cuda"), K)
    gt = gt.cpu().numpy()
    got = {}
    for name in ("exact", "line", "refine"):
        ids = torch.cat([o.indices for o in outputs[name]]).cpu().numpy()
        dists = torch.cat([o.dists for o in outputs[name]]).cpu().numpy()
        if ids.shape != (N_QUERIES, K) or not np.isfinite(
                dists[ids >= 0]).all():
            raise SmokeFailure(f"{name}: bad result shape or distances")
        got[name] = ids
    cand = torch.cat([o[0] for o in outputs["candidates"]]).cpu().numpy()
    valid = torch.cat([o[1] for o in outputs["candidates"]]).cpu().numpy()
    metrics = {
        "exact_R@1": recall_at(got["exact"], gt, (1,))["R@1"],
        "refine_R@1": recall_at(got["refine"], gt, (1,))["R@1"],
        "candidate_recall": candidate_recall(cand, valid, gt),
        "line_top10_intersection":
            intersection_at(got["line"], gt, (10,))["top10_intersection"],
        "exact_top10_intersection":
            intersection_at(got["exact"], gt, (10,))["top10_intersection"],
        "line_R@1": recall_at(got["line"], gt, (1,))["R@1"],
    }
    for key, lim in THRESHOLDS.items():
        print(f"{key:26s} {metrics[key]:.4f}  (threshold {lim}, "
              f"round 5 {ROUND5[key]})", flush=True)
    for name, lat in latency.items():
        print(f"{name:10s} QPS {lat['qps']:.0f} ({2 * N_QUERIES} queries in "
              f"batches of {BATCH})  batch latency p50 {lat['p50_ms']:.3f} "
              f"p90 {lat['p90_ms']:.3f} max {lat['max_ms']:.3f} ms",
              flush=True)
    failed = [k for k, lim in THRESHOLDS.items() if metrics[k] < lim]
    if failed:
        raise SmokeFailure(f"recall below threshold: {failed}")
    return launches, {"train_s": train_s, "build_s": build_s,
                      "serving": latency,
                      "recall": metrics, "profiles": profiles}


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
        print(f"{r['name']:14s} ms {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {r['library_ms']}  bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})  max_abs_err {r['max_abs_err']}  "
              f"[{'; '.join(c['case'] for c in r['shapes'])}]", flush=True)
        for c in r["shapes"]:
            print(f"    {c['case']:44s} ms {c['ms']:.4f}  plain "
                  f"{c['plain_ms']:.4f}  library {c['library_ms']}  bound "
                  f"{c['bound_ms']:.4f}", flush=True)

    check_other_paths(torch)
    print("other kernel paths (tiny top-k row, multi-row long scans, "
          "ragged scan widths): equal to their plain versions", flush=True)

    launches, summary = main_path(torch, P)
    for r in kernels.values():
        r["launches"] = launches[r["name"]]
    summary["card"] = card
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({"kernels": list(kernels.values()), **summary}, f,
                      indent=1)
    print(json.dumps({"kernels": list(kernels.values())}))
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
