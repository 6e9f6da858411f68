"""CLI: convert TexMex .fvecs/.bvecs/.ivecs datasets to .fmem/.umem/.imem.

Port of pqt_tpu/tools/convert.py (the reference's convert_* tools), streaming
so a billion-row file converts in bounded host memory.

Usage:
  python -m pqt_tpu_torch.tools.convert --src sift_base.bvecs \
      --dst sift_base.umem [--verify]
"""

from __future__ import annotations

import argparse

import numpy as np

from pqt_tpu_torch.io import texmex


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="input .fvecs/.bvecs/.ivecs")
    ap.add_argument("--dst", required=True, help="output .fmem/.umem/.imem")
    ap.add_argument("--chunk", type=int, default=1_000_000)
    ap.add_argument("--verify", action="store_true",
                    help="re-read the first rows of both files and compare")
    args = ap.parse_args(argv)

    num, dim = texmex.convert_xvecs_to_mem(args.src, args.dst, args.chunk)
    print(f"converted {num} vectors of dim {dim} -> {args.dst}")
    if args.verify:
        a = texmex.read_xvecs(args.src, min(num, 10000))
        b = texmex.read_mem(args.dst, min(num, 10000))
        if not np.array_equal(np.asarray(a, b.dtype), b):
            raise SystemExit("round-trip mismatch")
        print("verified OK")


if __name__ == "__main__":
    main()
