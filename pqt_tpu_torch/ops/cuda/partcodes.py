"""Kernel P, the build's part codes (csrc/partcodes.cu), and its wrapper.

Not a port of a Pallas kernel: the JAX package's encode
(pqt_tpu/models/db.py encode_part_codes, inside the jitted `_encode_chunk`)
leaves the level-2 distance tables and their argmin to XLA.  The port's
plain version (`part_codes_plain` in ops/distance.py, beside the tables
it reduces) runs them op by op over (n, p, c1 * c2) float32 tables: a
batched GEMM, three elementwise passes and the argmin.  The kernel keeps
the tables in registers and writes only the codes.  Its dot products are
summed by FMAs in dimension order, so a code can differ from the plain
version's where two distances are a near-tie, as cuBLAS's order is not
known.  On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.  It counts its launches in
`part_codes.launches`.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops import distance
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _ptr, _stream


def part_codes(x: torch.Tensor, codebook: torch.Tensor, cn: torch.Tensor,
               xn: torch.Tensor) -> torch.Tensor:
    """Per (row, part) the index of the least squared distance to the
    part's centroids, the first one: x (n, p * vl), codebook (p, k, vl),
    cn (p, k) the centroids' squared norms and xn (n, p) the rows' per-part
    ones, contiguous float32 on one device (`distance.part_norms`) -> (n,
    p) int64, as `part_codes_plain` (ops/distance.py) computes them."""
    ts = (x, codebook, cn, xn)
    if (x.dim() != 2 or codebook.dim() != 3 or cn.dim() != 2
            or xn.dim() != 2
            or any(t.dtype != torch.float32 or not t.is_contiguous()
                   for t in ts)):
        raise ValueError("part_codes: expected contiguous float32 x (n, d), "
                         "codebook (p, k, vl), cn (p, k) and xn (n, p), got "
                         + ", ".join(f"{t.dtype} {tuple(t.shape)}"
                                     for t in ts))
    n, d = x.shape
    p, k, vl = codebook.shape
    if (d != p * vl or k == 0 or tuple(cn.shape) != (p, k)
            or tuple(xn.shape) != (n, p)):
        raise ValueError(f"part_codes: x {tuple(x.shape)}, codebook "
                         f"{tuple(codebook.shape)}, cn {tuple(cn.shape)} and "
                         f"xn {tuple(xn.shape)} do not match")
    dev = x.device
    if all(t.device.type == "cpu" for t in ts):
        return distance.part_codes_plain(x, codebook, cn, xn)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("part_codes: expected CPU tensors or tensors on one "
                         "CUDA device, got "
                         + ", ".join(str(t.device) for t in ts))
    if p * k * vl >= 2 ** 31:
        raise ValueError(f"part_codes: a codebook of {p * k * vl} values, "
                         "above 2^31 - 1")
    codes = torch.empty((n, p), dtype=torch.int64, device=dev)
    if n == 0:
        return codes
    lib = build.load("partcodes")
    with torch.cuda.device(dev):
        err = lib.pqt_part_codes(_ptr(x), _ptr(codebook), _ptr(cn), _ptr(xn),
                                 n, p, k, vl, _ptr(codes), _stream(x))
    build.check(err, "part_codes")
    part_codes.launches += 1
    return codes


part_codes.launches = 0
