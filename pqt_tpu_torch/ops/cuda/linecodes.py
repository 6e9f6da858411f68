"""Kernel L, the build's line-code selection (csrc/linecodes.cu), and its
wrapper.

Not a port of a Pallas kernel: the JAX package's encode
(pqt_tpu/ops/linecodes.py best_lines, inside the jitted `_encode_chunk`)
leaves the residual, the triangle mask and the argmin to XLA, which fuses
them into one reduce.  The port's plain version (`line_codes_plain` in
ops/linecodes.py) runs the same chain op by op over (n, lp, c1, c1)
float32 intermediates; the kernel keeps them in registers and writes only
the packed codes and the per-part t3 terms, equal to the plain version's to
the bit.  It takes the line tables' terms, the line GEMM's output and the
norms (ops/distance.py subpart_sqdist_terms), and forms the segment
distances in registers as `subpart_sqdist_from_terms` rounds them, so the
tables are never written.  On CPU tensors the wrapper runs the plain
version (`line_codes_from_terms_plain`); on CUDA tensors it launches the
kernel or raises.  It counts its launches in `line_codes.launches`.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops import linecodes
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _ptr, _stream

LINE_CODES_MAX_C1 = 256          # csrc/linecodes.cu kMaxC1 (uint8 indices)


def line_codes(dot: torch.Tensor, xn: torch.Tensor, cn: torch.Tensor,
               pair_dists: torch.Tensor, lambda_bits: int = 16):
    """Per (vector, line part) the packed code of the line of least
    projection residual and its t3 term, over the segment distances
    ops/distance.py subpart_sqdist_from_terms(dot, xn, cn): dot (n, lp, c1)
    float32 at any strides (the line GEMM's output as it lies), xn (n, lp)
    and cn (c1, lp) contiguous float32, pair_dists (lp, c1, c1) contiguous
    float32, all on one device -> (codes (n, lp) int64, terms (n, lp)
    float32), as `line_codes_from_terms_plain` (ops/linecodes.py) computes
    them.  lambda_bits 16 or 8 (the compact payload's grid)."""
    if (dot.dim() != 3 or pair_dists.dim() != 3
            or dot.dtype != torch.float32
            or pair_dists.dtype != torch.float32
            or not pair_dists.is_contiguous()):
        raise ValueError(f"line_codes: expected 3-D float32 tensors and a "
                         f"contiguous pair table, got {dot.dtype} "
                         f"{tuple(dot.shape)} and {pair_dists.dtype} "
                         f"{tuple(pair_dists.shape)}")
    n, lp, c1 = dot.shape
    if tuple(pair_dists.shape) != (lp, c1, c1):
        raise ValueError(f"line_codes: pair table {tuple(pair_dists.shape)} "
                         f"does not match dot {tuple(dot.shape)}")
    if lambda_bits not in (8, 16) or not 1 <= c1 <= LINE_CODES_MAX_C1:
        raise ValueError(f"line_codes: lambda_bits {lambda_bits} (8 or 16) "
                         f"and c1 {c1} (1 to {LINE_CODES_MAX_C1})")
    if (tuple(xn.shape) != (n, lp) or tuple(cn.shape) != (c1, lp)
            or xn.dtype != torch.float32 or cn.dtype != torch.float32
            or not xn.is_contiguous() or not cn.is_contiguous()):
        raise ValueError(f"line_codes: expected contiguous float32 xn "
                         f"{(n, lp)} and cn {(c1, lp)} for dot "
                         f"{tuple(dot.shape)}, got {xn.dtype} "
                         f"{tuple(xn.shape)} and {cn.dtype} "
                         f"{tuple(cn.shape)}")
    ts = (dot, xn, cn, pair_dists)
    if all(t.device.type == "cpu" for t in ts):
        return linecodes.line_codes_from_terms_plain(dot, xn, cn, pair_dists,
                                                     lambda_bits)
    dev = dot.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("line_codes: expected CPU tensors or tensors on one "
                         "CUDA device, got "
                         + ", ".join(str(t.device) for t in ts))
    if n * lp >= 2 ** 31:
        raise ValueError(f"line_codes: {n} x {lp} codes, above 2^31 - 1")
    codes = torch.empty((n, lp), dtype=torch.int64, device=dev)
    terms = torch.empty((n, lp), dtype=torch.float32, device=dev)
    if n == 0 or lp == 0:
        return codes, terms
    lib = build.load("linecodes")
    with torch.cuda.device(dev):
        err = lib.pqt_line_codes(_ptr(dot), _ptr(xn), _ptr(cn), *dot.stride(),
                                 _ptr(pair_dists), n, lp, c1,
                                 int(lambda_bits == 8), _ptr(codes),
                                 _ptr(terms), _stream(dot))
    build.check(err, "line_codes")
    line_codes.launches += 1
    return codes, terms


line_codes.launches = 0
