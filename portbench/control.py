"""The readings the limits of a cell's correctness check are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--json PATH]

For each seed, at the cell's own size and through the cell's own set-up,
the cell's entry (`portbench/entries/<entry>.py` `control`) judges:

  * sound: the port as the window drives it;
  * control: the plain reference put in the port's place and computed in
    bfloat16, the precision below the configuration's float32;
  * faults planted in the port's output: an answer altered where it is
    produced, half of the batch left out, a step that returns its state
    unchanged (the previous batch's answers; the previous build's
    database; a tree whose Lloyd steps return their centroids unchanged).

A judgment is the same check a run makes.  The benchmark's runs never run
this; `portbench/tests/test_portbench_control.py` keeps it at a size a CPU
test holds.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import cells, common, reference as ref  # noqa: E402


def lloyd_unchanged(P):
    """Patch the port's Lloyd step to return its centroids unchanged;
    returns the undo."""
    from pqt_tpu_torch.models import kmeans
    real = kmeans._lloyd_step

    def step(centroids, *a, **kw):
        _, assign, done = real(centroids, *a, **kw)
        return centroids, assign, done
    kmeans._lloyd_step = step
    return lambda: setattr(kmeans, "_lloyd_step", real)


def faulty_tree(s):
    """The codebooks the port trains with its Lloyd steps broken."""
    undo = lloyd_unchanged(s.P)
    try:
        tree = s.P.train_tree(s.cfg, s.inputs.data[:s.config["n_train"]],
                              device=s.device)
    finally:
        undo()
    return tree.cb1.clone(), tree.cb2.clone()


def bf16_tree_check(s) -> dict:
    """The tree check of the reference's own tree trained in bfloat16."""
    train = torch.from_numpy(s.inputs.data[:s.config["n_train"]]).to(
        s.device)
    cb1, cb2 = ref.train_tree(s.pqt, train, s.seed, dtype=torch.bfloat16)
    return cells.check_tree(s, cb1.float(), cb2.float())


def readings(bench, cell: str, seed: int, device="cuda") -> dict:
    s = cells.prepare(bench, cell, seed, device)
    return bench.entry(s.traffic["entry"]).control(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = common.Bench()
    out = {}
    for seed in (int(x) for x in args.seeds.split(",")):
        out[seed] = readings(bench, args.workload, seed)
        print(json.dumps({"seed": seed, **out[seed]}), flush=True)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
