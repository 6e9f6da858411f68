"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and last `checks`, each number of the
correctness check beside its limit, which also end standard error.  The
run needs as many CUDA cards as the cell asks for and exits with another
code than 0, printing no result, without them, and when a module of JAX
or of the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = common.Bench()
    cell = bench.cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    from portbench import cells
    result = cells.run(bench, args.workload, args.seed, args.seconds,
                       bool(args.trace), device="cuda", t0=T0)
    loaded = common.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
