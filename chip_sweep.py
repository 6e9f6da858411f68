#!/usr/bin/env python3
"""Time kernel B (block_scan) in each of its modes along a ladder of row
lengths, kernel E (lut_gather), kernel H (gather_rows) along a ladder of
random reads, and the line re-rank (kernel C) at its path shapes, against
yardsticks, on one CUDA card: the source of the cut between B's modes
(SCAN_* in pqt_tpu_torch/ops/cuda/primitives.py), of the random-read rate
H's rows are held to, and of the comparison of C with an older tree's.

Run from the repository root:  python3 chip_sweep.py [--json PATH]
                                   [--only scan|lut|gather|rerank]
                                   [--cases NAME,...]

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

The line re-rank (`--only rerank`) runs chip_smoke.py's RERANK_SHAPES on
the same seeded inputs: the old route (kernel H's payload rows, then kernel
C over them, +inf where invalid), kernel C alone over those rows, and
`gather_rerank` where the tree has it, each warm and cold (candidates
drawn anew over rows read 256 MiB earlier), with a SHA-1 of the distances
so that two trees' results can be compared to the bit; a shape a tree's
kernel refuses is reported as refused.

Run from the root of an older checkout whose block_scan or gather_rows has
no plan, or that has no gather_rerank (with this script and chip_smoke.py
copied there), it times the wrappers as they are at the same shapes: the
baseline of a comparison in one call.
"""

import argparse
import hashlib
import json
import os
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


def main(json_path, only, cases):
    import torch
    if not torch.cuda.is_available():
        raise smoke.SmokeFailure("chip_sweep needs a CUDA card")
    card = smoke.card_line()
    print(card, flush=True)
    from pqt_tpu_torch.ops.cuda import build
    print(f"kernel build: nvcc {build.build_all():.2f} s", flush=True)
    smoke.device_ms(torch, lambda: torch.ones(8, device="cuda") + 1, reps=1)
    floor = smoke.device_ms(
        torch, lambda: torch.empty(1, device="cuda").fill_(0))
    print(f"launch floor (one-element fill) ms {floor:.4f}", flush=True)
    rows = []

    def emit(r):
        rows.append(r)
        if "refused" in r:
            print(f"{r['kernel']:10s} {r['case']:32s} {r['variant']:28s} "
                  f"refused: {r['refused']}", flush=True)
            return
        if "cumsum_ms" in r:
            extra = f"cumsum {r['cumsum_ms']:.4f}  copy {r['copy_ms']:.4f}"
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
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({"card": card, "launch_floor_ms": floor, "rows": rows},
                      f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--only", choices=("scan", "lut", "gather", "rerank"))
    ap.add_argument("--cases", help="comma-separated case names to run")
    args = ap.parse_args()
    try:
        main(args.json, args.only,
             set(args.cases.split(",")) if args.cases else None)
    except smoke.SmokeFailure as e:
        print(f"chip_sweep: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
