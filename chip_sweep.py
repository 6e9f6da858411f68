#!/usr/bin/env python3
"""Time kernel B (block_scan) in each of its modes along a ladder of row
lengths, and kernel E (lut_gather), against yardsticks, on one CUDA card:
the source of the cut between B's modes (SCAN_* in
pqt_tpu_torch/ops/cuda/primitives.py).

Run from the repository root:  python3 chip_sweep.py [--json PATH]
                                   [--only scan|lut] [--cases NAME,...]

Every variant is first held against the plain PyTorch version on the same
input (equal to the bit, or the run fails), then timed by its device time
(torch.profiler, chip_smoke.device_ms), with inputs warm in L2 as
chip_smoke.py times them.  The yardsticks: torch.cumsum and a copy of the
same bytes for B; table[idx], the sectors' bound and, at a 2 GiB table,
the same lookups in address order for E.  Prints one line per variant and
writes them all to PATH as JSON, with the card's name and power limit.

Run from the root of an older checkout whose block_scan has no plan (with
this script and chip_smoke.py copied there), it times the wrappers as
they are at the same shapes: the baseline of a comparison in one call.
"""

import argparse
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
        extra = (f"cumsum {r['cumsum_ms']:.4f}  copy {r['copy_ms']:.4f}"
                 if "cumsum_ms" in r
                 else f"table[idx] {r['index_ms']:.4f}  sectors' bound "
                      f"{r['sector_bound_ms']:.4f}")
        print(f"{r['kernel']:10s} {r['case']:24s} {r['variant']:28s} ms "
              f"{r['ms']:.4f}  {extra}  bound {r['bound_ms']:.4f}",
              flush=True)

    if only in (None, "scan"):
        sweep_scan(torch, emit, cases)
    if only in (None, "lut"):
        sweep_lut(torch, emit, cases)
    if json_path:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as f:
            json.dump({"card": card, "launch_floor_ms": floor, "rows": rows},
                      f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", metavar="PATH")
    ap.add_argument("--only", choices=("scan", "lut"))
    ap.add_argument("--cases", help="comma-separated case names to run")
    args = ap.parse_args()
    try:
        main(args.json, args.only,
             set(args.cases.split(",")) if args.cases else None)
    except smoke.SmokeFailure as e:
        print(f"chip_sweep: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
