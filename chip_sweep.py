#!/usr/bin/env python3
"""Time kernel B (block_scan) in each of its modes along a ladder of row
lengths, kernel E (lut_gather), kernel H (gather_rows) along a ladder of
random reads, the line re-rank (kernel C) at its path shapes, and kernel A
(bitonic_topk) on each route at its rows above 16384 elements, against
yardsticks, on one CUDA card: the source of the cut between B's modes
(SCAN_* in pqt_tpu_torch/ops/cuda/primitives.py), of the random-read rate
H's rows are held to, of the comparison of C with an older tree's, and of
the cut between A's routes (TOPK_CLUSTER_* there).

Run from the repository root:  python3 chip_sweep.py [--json PATH]
    [--only scan|lut|gather|rerank|topk|topk_ptxas|topk_stress|topk_path
            |linecodes|encode]
    [--cases NAME,...] [--topk-lib PATH] [--second-lib]

The random-read ladder (`--only gather`) gathers rows of 8, 72 and 128
bytes (the extent, SIFT1B payload and vector rows) at 2M and 512k uniform
positions from tables of 32 MiB, 256 MiB, 1 GiB and 4 GiB, with
`tab[pos]` beside it, and reports rows/s and 32-byte sector reads/s: the
rate the card reaches on random reads at each table size.

Every variant is first held against the plain PyTorch version on the same
input (equal to the bit, or the run fails), then timed by its device time
(torch.profiler, chip_smoke.device_ms), with inputs warm in L2 as
chip_smoke.py times them.  The yardsticks: torch.cumsum and a copy of the
same bytes for B; table[idx], the sectors' bound and, at a 2 GiB table,
the same lookups in address order for E.  Prints one line per variant and
writes them all to PATH as JSON, with the card's name and power limit.

Kernel A (`--only topk`) runs ladders of k at (256, 65536), of rows at
(rows, 65536) -> 256 and of row lengths from 20000 to 131072 (a select of
256, a merge of half the row and of the whole row), on every route that
takes them (one block a row, a thread-block cluster of 4 and of 8
blocks), each held to the plain version to the bit and timed beside
torch.topk and torch.sort(stable).  `--only topk_ptxas` builds variants
of csrc/topk.cu (TOPK_VARIANTS) with nvcc's register and spill report;
`--only topk --topk-lib PATH` then times one of them, a variant a process.
`--only topk_stress` launches every cluster route many times on the hard
rows (`--second-lib`: alternating between two loaded copies of the
library).  `--only topk_path` builds chip_smoke.py's SIFT1B database and
profiles its exact and BIG line queries with the pair select on either
route, alternately.

The line re-rank (`--only rerank`) runs chip_smoke.py's RERANK_SHAPES on
the same seeded inputs: the old route (kernel H's payload rows, then kernel
C over them, +inf where invalid), kernel C alone over those rows, and
`gather_rerank` where the tree has it, each warm and cold (candidates
drawn anew over rows read 256 MiB earlier), with a SHA-1 of the distances
so that two trees' results can be compared to the bit; a shape a tree's
kernel refuses is reported as refused.

Kernel L (`--only linecodes`, csrc/linecodes.cu) prints nvcc's register
and spill report of its kernels, then runs chip_smoke.py's
LINE_CODE_SHAPES at both lambda widths, warm and cold, beside the plain
version (equal to the bit, or the run fails), and its hard rows.
`--only encode` runs the build's encode as chip_smoke.py does (SIFT1B's
10M vectors into chunk files with `encode_s`' stages, a chunk's p50 and
profile replayed and eager, the encoder keys' pools; SIFT1M's build of
1M replayed and eager) in the tree it runs in: from an older checkout,
the baseline of a comparison in one call.

Run from the root of an older checkout whose block_scan or gather_rows has
no plan, or that has no gather_rerank (with this script and chip_smoke.py
copied there), it times the wrappers as they are at the same shapes: the
baseline of a comparison in one call.
"""

import argparse
import hashlib
import json
import os
import statistics
import sys

import chip_smoke as smoke


def scan_shapes():
    """(name, rows, n, exclusive): the main path's, SIFT1B_CONFIG's, and
    ladders of row lengths at 256 rows and at one row for the cut between
    the modes."""
    shapes = [("candidate_prefix", 256, 512, False),
              ("probe_compaction", 256, 512, True),
              ("survivor_compaction", 256, 768, True),
              ("filter_compaction", 256, 2048, True),
              ("csr_prefix", 1, 1 << 20, False),
              ("sift1b_candidate_prefix", 256, 8192, False),
              ("sift1b_compaction", 256, 32768, True),
              ("sift1b_csr_prefix", 1, 1 << 29, False),
              ("look-back rows", 3, 5_000_011, False)]
    shapes += [(f"ladder {n}", 256, n, True)
               for n in (1024, 4096, 16384, 65536)]
    shapes += [(f"ladder {n}", 1, n, False)
               for n in (4096, 16384, 1 << 16, 1 << 18)]
    return shapes


def sweep_scan(torch, emit, cases=None):
    from pqt_tpu_torch.ops.cuda import primitives as prim
    planned = hasattr(prim, "_scan_plan")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, rows, n, excl in scan_shapes():
        if cases and name not in cases:
            continue
        # 0/1 flags or Poisson(1) counts, as the compactions and the CSR
        # prefix see them
        x = torch.randint(0, 2, (rows, n), generator=gen, device="cuda",
                          dtype=torch.int32)
        want = prim.block_scan_plain(x, excl)
        case = {"kernel": "block_scan", "case": name, "shape": [rows, n],
                "exclusive": excl,
                "bound_ms": smoke.bound(2 * rows * n * 4, rows * n)[0],
                "cumsum_ms": smoke.device_ms(
                    torch, lambda: torch.cumsum(x, -1, dtype=torch.int32)),
                # a copy moves the same bytes: the streaming yardstick
                "copy_ms": smoke.device_ms(torch, lambda: x.clone())}
        variants = [("wrapper", None)]
        if planned:
            case["plan"] = prim._scan_plan(rows, n)._asdict()
            variants += [(f"{p.mode} mode", p)
                         for p in smoke.scan_plans(prim, rows, n)]
        for label, plan in variants:
            def run(plan=plan):
                if plan is None:
                    return prim.block_scan(x, excl)
                return prim._scan_launch(x, excl, plan)
            if not torch.equal(run(), want):
                raise smoke.SmokeFailure(f"block_scan {name} {label} differs")
            emit(dict(case, variant=label, ms=smoke.device_ms(torch, run)))
        del x, want
        torch.cuda.empty_cache()


def lut_shapes(torch, gen):
    """(name, table, n): the main path's lookups and SIFT1B_CONFIG's."""
    pair = (torch.rand(1 << 17, generator=gen, device="cuda") < 0.3
            ).to(torch.uint8)
    small = torch.randint(0, 9, (1 << 20,), generator=gen, device="cuda",
                          dtype=torch.int32)
    yield "pair_occ", pair, 256 * 2 * 256
    yield "counts_unfiltered", small, 256 * 2048
    yield "counts_filtered", small, 256 * 768
    yield "prefix", small, 256 * 512
    big = torch.randint(0, 9, (1 << 29,), generator=gen, device="cuda",
                        dtype=torch.int32)
    yield "sift1b_counts", big, 256 * 32768
    yield "sift1b_prefix", big, 256 * 8192


def sweep_lut(torch, emit, cases=None):
    from pqt_tpu_torch.ops.cuda import gather as ga
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, table, n in lut_shapes(torch, gen):
        if cases and name not in cases:
            continue
        idx = torch.randint(0, table.shape[0], (n,), generator=gen,
                            device="cuda", dtype=torch.int32)
        want = ga.lut_gather_plain(table, idx)
        es = table.element_size()
        touched = torch.unique(idx)
        sectors = int(torch.unique(touched * es // 32).numel())
        case = {"kernel": "lut_gather", "case": name,
                "table": [table.shape[0], str(table.dtype)], "n": n,
                "bound_ms": smoke.bound(n * 4 + n * es + touched.numel() * es,
                                        0)[0],
                "sector_bound_ms": smoke.bound(n * 4 + n * es + sectors * 32,
                                               0)[0],
                "index_ms": smoke.device_ms(torch, lambda: table[idx])}
        if not torch.equal(ga.lut_gather(table, idx), want):
            raise smoke.SmokeFailure(f"lut_gather {name} differs")
        emit(dict(case, variant="wrapper", ms=smoke.device_ms(
            torch, lambda: ga.lut_gather(table, idx))))
        if table.numel() * es > (64 << 20):
            # the same sectors in address order: what the table's random
            # placement costs beyond the sectors themselves
            ordered = idx.sort().values
            emit(dict(case, variant="wrapper, indices sorted",
                      ms=smoke.device_ms(
                          torch, lambda: ga.lut_gather(table, ordered))))
            del ordered
        del idx, want, touched
    torch.cuda.empty_cache()


# (row bytes, dtype, width), table sizes in bytes, positions per gather
LADDER_ROWS = ((8, "int32", 2), (72, "int32", 18), (128, "uint8", 128))
LADDER_TABLES = (32 << 20, 256 << 20, 1 << 30, 4 << 30)
LADDER_POSITIONS = (2 << 20, 512 << 10)


def sweep_gather(torch, emit, cases=None):
    from pqt_tpu_torch.ops.cuda import gather as ga
    planned = hasattr(ga, "_gather_plan")
    gen = torch.Generator(device="cuda").manual_seed(4)
    buf = torch.randint(0, 256, (LADDER_TABLES[-1],), generator=gen,
                        device="cuda", dtype=torch.uint8)
    for row_bytes, dtype, width in LADDER_ROWS:
        for size in LADDER_TABLES:
            n_rows = size // row_bytes
            tab = buf[:n_rows * row_bytes].view(getattr(torch, dtype)).view(
                n_rows, width)
            for n_pos in LADDER_POSITIONS:
                name = f"{row_bytes} B rows, {size >> 20} MiB, {n_pos}"
                if cases and name not in cases:
                    continue
                pos = torch.randint(0, n_rows, (n_pos,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                start = pos.long() * row_bytes
                reads = int(((start + row_bytes - 1) // 32 - start // 32
                             + 1).sum())
                touched = torch.unique(pos)
                case = {"kernel": "gather_rows", "case": name,
                        "row_bytes": row_bytes, "table_bytes": n_rows *
                        row_bytes, "positions": n_pos, "sector_reads": reads,
                        "bound_ms": smoke.bound(
                            n_pos * (4 + row_bytes)
                            + touched.numel() * row_bytes, 0)[0],
                        "sector_bound_ms": smoke.bound(
                            n_pos * (4 + row_bytes) + 32 * smoke.
                            sectors_touched(torch, pos, row_bytes), 0)[0],
                        "index_ms": smoke.device_ms(torch, lambda: tab[pos])}
                if planned:
                    case["plan"] = ga._gather_plan(n_pos, row_bytes, 1,
                                                   tab.data_ptr())._asdict()
                if not torch.equal(ga.gather_rows(tab, pos),
                                   ga.gather_rows_plain(tab, pos)):
                    raise smoke.SmokeFailure(f"gather_rows {name} differs")
                ms = smoke.device_ms(torch, lambda: ga.gather_rows(tab, pos))
                emit(dict(case, variant="wrapper", ms=ms,
                          rows_per_s=n_pos / ms * 1e3,
                          sector_reads_per_s=reads / ms * 1e3))
                del pos, start, touched
            del tab
    del buf
    torch.cuda.empty_cache()


def sweep_rerank(torch, emit, cases=None):
    from pqt_tpu_torch.ops.cuda import gather as ga
    from pqt_tpu_torch.ops.cuda import rerank as rr
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, (payload, draw, valid, q, compact), (b, k, lp, c1, _) in \
            smoke.rerank_cases(torch, gen, cases):
        n, w = payload.shape
        pos = draw()
        sets = [draw() for _ in range(
            -(-smoke.COLD_SET_BYTES // (b * k * 4 * w)))]
        touched = int(torch.unique(pos).numel())
        case = {"kernel": "rerank", "case": name, "payload": [n, w],
                "shape": [b, k], "lp": lp, "c1": c1, "compact": compact,
                "bound_ms": smoke.bound(touched * 4 * w + b * k * 13
                                        + b * lp * c1 * 4, 4 * b * k * lp)[0]}
        rows = ga.gather_rows(payload, pos)
        variants = [
            ("old route", lambda p: smoke.old_line_route(
                ga, rr, payload, p, valid, q, compact)),
            ("C over gathered rows", None)]
        if hasattr(rr, "gather_rerank"):
            variants.append(("gather_rerank", lambda p: rr.gather_rerank(
                payload, p, valid, q, compact)))
        for label, fn in variants:
            try:
                if fn is None:
                    d = rr.rerank_fused(rows, q, compact)
                else:
                    d = fn(pos)[1]
            except NotImplementedError as e:
                emit(dict(case, variant=label, refused=str(e)))
                continue
            r = dict(case, variant=label, dists_sha1=hashlib.sha1(
                d.cpu().numpy().tobytes()).hexdigest())
            if fn is None:
                r["ms"] = smoke.device_ms(
                    torch, lambda: rr.rerank_fused(rows, q, compact))
            else:
                r["ms"] = smoke.device_ms(torch, lambda: fn(pos))
                r["cold_ms"] = smoke.rotating_ms(torch, fn, sets)
            emit(r)
        del payload, pos, sets, rows
        torch.cuda.empty_cache()


def sweep_topk(torch, emit, cases=None):
    """Kernel A on every route that takes each shape (one block a row, a
    cluster of 4 and of 8 blocks), each held to the plain version to the
    bit and timed beside torch.topk and torch.sort(stable): ladders of k at
    (256, 65536), of rows at (rows, 65536) -> 256 (SIFT1B's pair select at
    batch 64 and 256, and between) and of row lengths from 20000 to 131072
    (a select of 256, a merge of half the row and of the whole row), the
    source of the cut between the routes.  chip_smoke.py's phase 3 times
    and holds every route at the paths' own shapes and on the hard rows."""
    from pqt_tpu_torch.ops.cuda import primitives as prim
    gen = torch.Generator(device="cuda").manual_seed(0)
    ladder = [(f"k ladder {k}", 256, 1 << 16, k)
              for k in (128, 256, 512, 1024, 2048, 4096)]
    ladder += [(f"rows ladder {b}", b, 1 << 16, 256)
               for b in (128, 512, 1024)]
    ladder += [(f"n ladder {n} {label}", 64, n, k(n))
               for n in (20000, 32768, 40000, 49152, 70001, 100000, 131072)
               for label, k in (("select", lambda n: 256),
                                ("merge", lambda n: n // 2),
                                ("merge all", lambda n: n))]
    for name, b, n, k in ladder:
        if cases and name not in cases:
            continue
        x = torch.rand((b, n), generator=gen, device="cuda") * 1e4
        x[: b // 2] = torch.round(x[: b // 2] / 1e3)
        plans = [(label, p) for label, p in smoke.topk_plans(prim, n, k)
                 if label.split(" cluster")[0] == prim._topk_plan(n, k).mode]
        if len(plans) < 2:
            continue
        pv, pi = prim.bitonic_topk_plain(x, k)
        case = {"kernel": "topk", "case": name, "shape": [b, n, k],
                "plan": prim._topk_plan(n, k)._asdict(),
                "bound_ms": smoke.bound(b * n * 4 + b * k * 8, b * n)[0],
                "topk_ms": smoke.device_ms(
                    torch, lambda: torch.topk(x, k, largest=False)),
                "sort_ms": smoke.device_ms(
                    torch, lambda: torch.sort(x, stable=True))}
        for label, p in plans:
            v, i = prim._topk_launch(x, k, p)
            if not (torch.equal(v, pv) and torch.equal(i, pi)):
                raise smoke.SmokeFailure(f"bitonic_topk {name} ({label}) "
                                         "differs")
            emit(dict(case, variant=label, ms=smoke.device_ms(
                torch, lambda: prim._topk_launch(x, k, p)),
                reads=smoke.topk_reads(torch, prim, x, k, p)[0]))
        del x, pv, pi


# Variants of csrc/topk.cu that `--only topk_ptxas` builds: (name, the
# text replaced, its replacement).  The cluster kernel's launch bounds:
# "select min blocks 2" holds both select instances to 64 registers (two
# blocks an SM), "select min blocks 1" lets both use 128 (one block an SM);
# as built, the 32-key select takes 128 and the 16-key one 64.
_TOPK_BOUNDS = "__launch_bounds__(kClusterThreads,\n" \
    "                                  MERGE || ITEMS == 32 ? 1 : 2)"
TOPK_VARIANTS = (
    ("as built", None, None),
    ("select min blocks 2", _TOPK_BOUNDS,
     "__launch_bounds__(kClusterThreads, MERGE ? 1 : 2)"),
    ("select min blocks 1", _TOPK_BOUNDS,
     "__launch_bounds__(kClusterThreads, 1)"))


def variant_dir(name):
    from pqt_tpu_torch.ops.cuda import build
    return build.BUILD_ROOT / "variants" / name.replace(" ", "-")


def ptxas_report(log):
    """(function, registers, stack bytes, spill store bytes, spill load
    bytes) of each kernel in nvcc's `-Xptxas -v` log."""
    import re
    rows, fn, frame = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, frame = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            frame = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows.append((fn, int(m.group(1))) + (frame or (0, 0, 0)))
            fn = None
    return rows


def demangle(names):
    import shutil
    import subprocess
    if not shutil.which("c++filt"):
        return list(names)
    out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return [o.replace("(anonymous namespace)::", "") for o in out]


def sweep_topk_ptxas(torch, emit, cases=None):
    """Build each of TOPK_VARIANTS of csrc/topk.cu with nvcc's register
    report (`-Xptxas -v`) into pqt_tpu_torch/_build/variants/<name>/, and
    report each kernel's registers and spills; `--topk-lib` then times a
    variant."""
    import subprocess
    from pqt_tpu_torch.ops.cuda import build
    src = (build.CSRC / "topk.cu").read_text()
    for name, old, new in TOPK_VARIANTS:
        if old is not None and src.count(old) != 1:
            raise smoke.SmokeFailure(f"topk variant {name}: {old!r} is not "
                                     "in csrc/topk.cu once")
        out = variant_dir(name)
        out.mkdir(parents=True, exist_ok=True)
        (out / "topk.cu").write_text(src if old is None
                                     else src.replace(old, new))
        proc = subprocess.run(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / "libtopk.so"), str(out / "topk.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise smoke.SmokeFailure(f"topk variant {name}: nvcc failed\n"
                                     f"{proc.stdout}{proc.stderr}")
        rows = ptxas_report(proc.stdout + proc.stderr)
        for (fn, regs, stack, st, ld), pretty in zip(
                rows, demangle([r[0] for r in rows])):
            if cases and not any(c in pretty for c in cases):
                continue
            emit({"kernel": "ptxas", "variant": name, "function": pretty,
                  "registers": regs, "stack_bytes": stack,
                  "spill_store_bytes": st, "spill_load_bytes": ld,
                  "library": str(out / "libtopk.so")})


def use_topk_library(path):
    """Load kernel A's library from `path` (a variant that
    `--only topk_ptxas` built) in place of the package's build."""
    import ctypes
    from pqt_tpu_torch.ops.cuda import build
    lib = ctypes.CDLL(os.path.abspath(path))
    for fn, (argtypes, restype) in build._SIGNATURES["topk"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    build._libs["topk"] = lib
    return lib


def sweep_topk_stress(torch, emit, cases=None, second_lib=False,
                      repeats=500):
    """Launch every cluster route of kernel A (select and merge, 4 and 8
    blocks) `repeats` times back to back on each of chip_smoke.py's hard
    rows and at SIFT1B's long-row shapes, each result held to the plain
    version to the bit.  With `second_lib`, a second copy of the built
    library is loaded and the launches alternate between the two.  A
    failed launch ends the process (the context is lost): the counts so far
    are printed first."""
    import shutil
    from pqt_tpu_torch.ops.cuda import build
    from pqt_tpu_torch.ops.cuda import primitives as prim
    libs = [build.load("topk")]
    if second_lib:
        copy = variant_dir("second copy")
        copy.mkdir(parents=True, exist_ok=True)
        shutil.copy(build._build_dir(build.find_nvcc()) / "libtopk.so",
                    copy / "libtopk.so")
        libs.append(use_topk_library(copy / "libtopk.so"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = list(smoke.topk_hard_rows(torch, gen))
    for b, k in ((128, 256), (512, 256), (64, 32768), (64, 1 << 16)):
        x = torch.rand((b, 1 << 16), generator=gen, device="cuda") * 1e4
        x[: b // 2] = torch.round(x[: b // 2] / 1e3)
        rows.append((f"SIFT1B shape ({b}, 65536) -> {k}", x, k))
    counts = {}
    for name, x, k in rows:
        if cases and name not in cases:
            continue
        want = prim.bitonic_topk_plain(x, k)
        for label, p in smoke.topk_plans(prim, x.shape[1], k, every=True):
            if not p.cluster:
                continue
            route = f"{label.split(' cluster')[0]} cluster {p.cluster}"
            c = counts.setdefault(route, {"launches": 0, "differ": 0})
            for r in range(repeats):
                build._libs["topk"] = libs[r % len(libs)]
                try:
                    v, i = prim._topk_launch(x, k, p)
                    same = torch.equal(v, want[0]) and torch.equal(i, want[1])
                except RuntimeError as e:
                    print(f"topk stress: {route} on {name!r} failed after "
                          f"{json.dumps(counts)}: {e}", flush=True)
                    raise smoke.SmokeFailure(f"topk stress: {e}")
                c["launches"] += 1
                c["differ"] += not same
    for route, c in counts.items():
        emit({"kernel": "topk_stress", "variant": route,
              "libraries": len(libs), **c})
    if any(c["differ"] for c in counts.values()):
        raise smoke.SmokeFailure(f"topk stress: results differ {counts}")


def sweep_topk_path(torch, emit, cases=None, rounds=8, batch=64):
    """SIFT1B's exact and BIG line queries at batch 64 (chip_smoke.py's
    SIFT1B phase: 10M vectors at SIFT1B_CONFIG's widths), profiled with the
    pair select (B*2, 65536) -> 256 on the cluster route and on the
    one-block route (TOPK_CLUSTER_SELECT_MAX_K set to 0), in the order
    ABBA `rounds` times: each profile's device busy ms and kernel A's
    share of it, and the two routes' ids held equal.  Per mode and route:
    the median busy time and the distance between its quartiles; per mode,
    how many of the 2 x `rounds` pairs (the two profiles next to each
    other in ABBA) the cluster select's busy time was the lower."""
    import tempfile
    import pqt_tpu_torch as P
    from pqt_tpu_torch.ops.cuda import primitives as prim
    routes = {"cluster select": prim.TOPK_CLUSTER_SELECT_MAX_K,
              "one-block select": 0}
    with tempfile.TemporaryDirectory(prefix="pqt_sweep_") as workdir:
        built = smoke.sift1b_database(torch, P, workdir)
        modes = smoke.query_modes(P, built["cfg"], built["tree"],
                                  built["db"], ("exact", "big_line"))
        x = built["qd"][:batch]
        outputs = {}
        for route, cap in routes.items():
            prim.TOPK_CLUSTER_SELECT_MAX_K = cap
            outputs[route] = {m: [fn(x)] for m, fn in modes.items()}
        if not smoke.same_results(torch, *outputs.values()):
            raise smoke.SmokeFailure("topk path: the routes' ids or "
                                     "distances differ")
        order = list(routes) + list(routes)[::-1]
        busy = {}
        for rd in range(rounds):
            for route in order:
                prim.TOPK_CLUSTER_SELECT_MAX_K = routes[route]
                for m, fn in modes.items():
                    pr = smoke.profile_batch(torch, fn, x)
                    if "device_busy_ms" not in pr:
                        raise smoke.SmokeFailure(f"topk path: {pr}")
                    top = sum(ms for name, ms in pr["top_kernels_ms"]
                              if "topk" in name or "radix_select" in name)
                    emit({"kernel": "topk_path", "case": m, "variant": route,
                          "round": rd, "busy_ms": pr["device_busy_ms"],
                          "wall_ms": pr["wall_ms"], "topk_ms": top})
                    busy.setdefault((m, route), []).append(
                        pr["device_busy_ms"])
        prim.TOPK_CLUSTER_SELECT_MAX_K = routes["cluster select"]
    for m in modes:
        for route in routes:
            v = busy[(m, route)]
            q = statistics.quantiles(v, n=4)
            print(f"topk path {m:9s} {route:18s} busy ms median "
                  f"{statistics.median(v):.4f}  quartiles {q[0]:.4f}-"
                  f"{q[2]:.4f}  min {min(v):.4f}  max {max(v):.4f}  n "
                  f"{len(v)}", flush=True)
        a, b = (busy[(m, route)] for route in routes)
        wins = sum(x < y for x, y in zip(a, b))
        print(f"topk path {m:9s} the cluster select lower in {wins} of "
              f"{len(a)} pairs", flush=True)


def sweep_linecodes(torch, emit, cases=None):
    """Kernel L (csrc/linecodes.cu): nvcc's register and spill report of
    its kernels (`-Xptxas -v`, built into pqt_tpu_torch/_build/variants/
    linecodes/, not loaded); then at chip_smoke.py's LINE_CODE_SHAPES at
    both lambda widths, fed from the line GEMM's output, held to the plain
    version to the bit and timed warm and cold (a rotating set of inputs
    larger than L2) beside it, with the layouts the GEMM's output and the
    tables come in; then chip_smoke.py's hard rows, each held to the
    bit."""
    import subprocess
    from pqt_tpu_torch.ops import distance as D
    from pqt_tpu_torch.ops import linecodes as L
    from pqt_tpu_torch.ops.cuda import build
    from pqt_tpu_torch.ops.cuda import linecodes as lc
    out = variant_dir("linecodes")
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / "liblinecodes.so"), str(build.CSRC / "linecodes.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise smoke.SmokeFailure(f"linecodes.cu: nvcc failed\n"
                                 f"{proc.stdout}{proc.stderr}")
    rows = ptxas_report(proc.stdout + proc.stderr)
    for (fn, regs, stack, st, ld), pretty in zip(
            rows, demangle([r[0] for r in rows])):
        emit({"kernel": "ptxas", "variant": "linecodes", "function": pretty,
              "registers": regs, "stack_bytes": stack,
              "spill_store_bytes": st, "spill_load_bytes": ld})
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = smoke.ENCODE_CHUNK
    for case, lp, c1 in smoke.LINE_CODE_SHAPES:
        if cases and case not in cases:
            continue
        dot, xn, cn, p = smoke.line_terms_case(torch, gen, n, lp, c1)
        pairs = n * lp * c1 * (c1 - 1) // 2
        b_ms = smoke.bound(n * lp * c1 * 4 + lp * c1 * c1 * 4 + n * lp * 12,
                           8 * pairs)[0]
        for bits in (16, 8):
            if not smoke.same_line_codes(
                    torch, lc.line_codes(dot, xn, cn, p, bits),
                    L.line_codes_from_terms_plain(dot, xn, cn, p, bits)):
                raise smoke.SmokeFailure(f"line_codes {case} {bits} bits "
                                         "differs from the plain version")
            emit({"kernel": "line_codes", "case": f"{case} ({n},{lp},{c1})",
                  "variant": f"lambda {bits} bits", "bound_ms": b_ms,
                  "ms": smoke.device_ms(torch, lambda: lc.line_codes(
                      dot, xn, cn, p, bits)),
                  "cold_ms": smoke.cold_ms(
                      torch, lambda t: lc.line_codes(t, xn, cn, p, bits),
                      dot),
                  "plain_ms": smoke.device_ms(
                      torch, lambda: L.line_codes_from_terms_plain(
                          dot, xn, cn, p, bits), reps=5),
                  "dot_strides": list(dot.stride()),
                  "table_strides": list(D.subpart_sqdist_from_terms(
                      dot[:8], xn[:8], cn).stride())})
        del dot, xn, cn, p
        torch.cuda.empty_cache()
    for name, dot, xn, cn, p in smoke.line_code_hard_cases(torch, gen):
        for bits in (16, 8):
            if not smoke.same_line_codes(
                    torch, lc.line_codes(dot, xn, cn, p, bits),
                    L.line_codes_from_terms_plain(dot, xn, cn, p, bits)):
                raise smoke.SmokeFailure(f"line_codes {name} "
                                         f"{tuple(dot.shape)} {bits} bits "
                                         "differs")
    torch.cuda.synchronize()
    print("line_codes: every hard row equal to the plain version to the "
          "bit at both lambda widths", flush=True)


def sweep_encode(torch, emit, cases=None):
    """The build's encode in the tree as it stands (this one, or an older
    checkout with this script and chip_smoke.py copied there: the baseline
    of a comparison in one call).  chip_smoke.py's SIFT1B phase up to its
    chunk files: the 10M-vector fixture drawn on the card, the tree trained
    on 200k, `encode_s` into 5 chunk files with its stages, a 65536-row
    chunk's p50 replayed and eager with one profiled chunk each (device
    busy ms, idle share), the encoder keys' pools; then chip_smoke.py's
    SIFT1M build of 1M rows (phase 4's tree and configuration) replayed,
    its first call capturing, again, and eager."""
    import tempfile
    import numpy as np
    import pqt_tpu_torch as P
    from pqt_tpu_torch.models import db as DB
    from pqt_tpu_torch.utils import graphs as G
    cfg = P.SIFT1B_CONFIG.replace(kmeans_iters=8, train_subsample=100_000)
    _, draw = smoke.sift1b_fixture(torch, smoke.N_1B)
    data = torch.empty((smoke.N_1B, 128), dtype=torch.uint8, device="cuda")
    for s in range(0, smoke.N_1B, smoke.N_1B_CHUNK):
        data[s:s + smoke.N_1B_CHUNK] = draw(min(smoke.N_1B_CHUNK,
                                                smoke.N_1B - s))
    tree = smoke.trained(torch, P, cfg, data[:smoke.N_1B_TRAIN])[0]
    with tempfile.TemporaryDirectory(prefix="pqt_sweep_") as workdir:
        paths = [os.path.join(workdir, f"chunk{i}.npz")
                 for i in range(-(-smoke.N_1B // smoke.N_1B_CHUNK))]
        encode_s, spans = smoke.encode_files(P, cfg, tree, data, paths)
    x = data[:smoke.ENCODE_CHUNK]
    occ = DB._file_pair_occ((cfg.p // 2, cfg.part_radix ** 2), x.device)
    offset = DB._offset(0, x.device)
    chunk = {}
    for name, fn in (("replayed", DB.chunk_encoder),
                     ("eager", DB.chunk_encoder.__wrapped__)):
        def call(xb, fn=fn):
            return fn(cfg, tree, xb, offset, occ)
        chunk[name] = {"p50_ms": smoke.p50_ms(torch, call, x),
                       "profile": smoke.profile_batch(torch, call, x)}
    pools = smoke.build_graphs_report("the SIFT1B encode")
    emit({"kernel": "encode", "case": "sift1b", "variant": "tree",
          "encode_s": encode_s, "spans": spans,
          "chunk": chunk,
          "pools_mib": [[r["program"], r["key"], r["mib"]] for r in pools]})
    smoke.clear_build_graphs()
    del data, x, occ
    torch.cuda.empty_cache()

    mcfg = P.SIFT1M_CONFIG.replace(
        kmeans_iters=8, train_subsample=100_000, hash_size=1 << 20,
        max_bins=512, max_candidates=1024, pair_top_m=128, enum_width=512,
        pair_filter=True)
    rows = smoke.make_sift_like(smoke.N_DB, mcfg.dim,
                                np.random.default_rng(0))[0]
    mtree = smoke.trained(torch, P, mcfg, rows[:smoke.N_TRAIN])[0]
    builds = {}
    for name in ("first", "replayed"):
        builds[name] = smoke.timed(torch, lambda: P.build_database(
            mcfg, mtree, rows, keep_vectors=True, device="cuda"))[1]
    pools = smoke.build_graphs_report("the SIFT1M build")
    with G.eager():
        builds["eager"] = smoke.timed(torch, lambda: P.build_database(
            mcfg, mtree, rows, keep_vectors=True, device="cuda"))[1]
    emit({"kernel": "encode", "case": "sift1m_build", "variant": "tree",
          "build_s": builds,
          "pools_mib": [[r["program"], r["key"], r["mib"]] for r in pools]})
    smoke.clear_build_graphs()


def main(json_path, only, cases, topk_lib=None, second_lib=False):
    import torch
    if not torch.cuda.is_available():
        raise smoke.SmokeFailure("chip_sweep needs a CUDA card")
    card = smoke.card_line()
    print(card, flush=True)
    from pqt_tpu_torch.ops.cuda import build
    if topk_lib:
        # kernel A alone, from a variant's library: no other is loaded
        if only != "topk":
            raise smoke.SmokeFailure("--topk-lib goes with --only topk")
        use_topk_library(topk_lib)
        print(f"kernel A from {topk_lib}", flush=True)
    elif only != "topk_ptxas":
        print(f"kernel build: nvcc {build.build_all():.2f} s", flush=True)
    smoke.device_ms(torch, lambda: torch.ones(8, device="cuda") + 1, reps=1)
    floor = smoke.device_ms(
        torch, lambda: torch.empty(1, device="cuda").fill_(0))
    print(f"launch floor (one-element fill) ms {floor:.4f}", flush=True)
    rows = []

    def emit(r):
        rows.append(r)
        if r["kernel"] in ("ptxas", "topk_stress", "topk_path", "encode"):
            print(" ".join(f"{k} {json.dumps(v) if isinstance(v, dict) else v}"
                           for k, v in r.items()), flush=True)
            return
        if "refused" in r:
            print(f"{r['kernel']:10s} {r['case']:32s} {r['variant']:28s} "
                  f"refused: {r['refused']}", flush=True)
            return
        if "topk_ms" in r:
            extra = (f"torch.topk {r['topk_ms']:.4f}  torch.sort "
                     f"{r['sort_ms']:.4f}")
            if r["reads"] is not None:
                extra += f"  reads {r['reads']:.2f} (modelled)"
        elif "cumsum_ms" in r:
            extra = f"cumsum {r['cumsum_ms']:.4f}  copy {r['copy_ms']:.4f}"
        elif "plain_ms" in r:
            extra = (f"cold {r['cold_ms']:.4f}  plain {r['plain_ms']:.4f}  "
                     f"line tables' strides {r['table_strides']}")
        elif "index_ms" in r:
            extra = (f"table[idx] {r['index_ms']:.4f}  sectors' bound "
                     f"{r['sector_bound_ms']:.4f}")
        else:
            extra = (f"cold {r['cold_ms']:.4f}" if "cold_ms" in r else "") + \
                f"  dists sha1 {r['dists_sha1'][:16]}"
        if "rows_per_s" in r:
            extra += (f"  {r['rows_per_s'] / 1e9:.2f} G rows/s  "
                      f"{r['sector_reads_per_s'] / 1e9:.2f} G sector "
                      "reads/s")
        print(f"{r['kernel']:10s} {r['case']:32s} {r['variant']:28s} ms "
              f"{r['ms']:.4f}  {extra}  bound {r['bound_ms']:.4f}",
              flush=True)

    if only in (None, "scan"):
        sweep_scan(torch, emit, cases)
    if only in (None, "lut"):
        sweep_lut(torch, emit, cases)
    if only in (None, "gather"):
        sweep_gather(torch, emit, cases)
    if only in (None, "rerank"):
        sweep_rerank(torch, emit, cases)
    if only in (None, "topk"):
        sweep_topk(torch, emit, cases)
    if only == "topk_ptxas":
        sweep_topk_ptxas(torch, emit, cases)
    if only == "topk_stress":
        sweep_topk_stress(torch, emit, cases, second_lib)
    if only == "topk_path":
        sweep_topk_path(torch, emit, cases)
    if only == "linecodes":
        sweep_linecodes(torch, emit, cases)
    if only == "encode":
        sweep_encode(torch, emit, cases)
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({"card": card, "launch_floor_ms": floor, "rows": rows},
                      f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--only", choices=("scan", "lut", "gather", "rerank",
                                       "topk", "topk_ptxas", "topk_stress",
                                       "topk_path", "linecodes", "encode"))
    ap.add_argument("--cases", help="comma-separated case names to run")
    ap.add_argument("--topk-lib", metavar="PATH",
                    help="with --only topk: kernel A's library to time (a "
                    "variant --only topk_ptxas built)")
    ap.add_argument("--second-lib", action="store_true",
                    help="with --only topk_stress: alternate the launches "
                    "between two loaded copies of kernel A's library")
    args = ap.parse_args()
    try:
        main(args.json, args.only,
             set(args.cases.split(",")) if args.cases else None,
             args.topk_lib, args.second_lib)
    except smoke.SmokeFailure as e:
        print(f"chip_sweep: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
