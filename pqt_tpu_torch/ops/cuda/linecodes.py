"""Kernel L, the build's line-code selection (csrc/linecodes.cu), and its
wrapper.

Not a port of a Pallas kernel: the JAX package's encode
(pqt_tpu/ops/linecodes.py best_lines, inside the jitted `_encode_chunk`)
leaves the residual, the triangle mask and the argmin to XLA, which fuses
them into one reduce.  The port's plain version (`line_codes_plain` in
ops/linecodes.py) runs the same chain op by op over (n, lp, c1, c1)
float32 intermediates; the kernel keeps them in registers and writes only
the packed codes and the per-part t3 terms, equal to the plain version's to
the bit.  On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.  It counts its launches in
`line_codes.launches`.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops import linecodes
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _ptr, _stream

LINE_CODES_MAX_C1 = 256          # csrc/linecodes.cu kMaxC1 (uint8 indices)


def line_codes(part_dists: torch.Tensor, pair_dists: torch.Tensor,
               lambda_bits: int = 16):
    """Per (vector, line part) the packed code of the line of least
    projection residual and its t3 term: part_dists (n, lp, c1) and
    pair_dists (lp, c1, c1), contiguous float32 on one device ->
    (codes (n, lp) int64, terms (n, lp) float32), as `line_codes_plain`
    (ops/linecodes.py) computes them.  lambda_bits 16 or 8 (the compact
    payload's grid)."""
    if (part_dists.dim() != 3 or pair_dists.dim() != 3
            or part_dists.dtype != torch.float32
            or pair_dists.dtype != torch.float32
            or not part_dists.is_contiguous()
            or not pair_dists.is_contiguous()):
        raise ValueError(f"line_codes: expected contiguous 3-D float32 "
                         f"tensors, got {part_dists.dtype} "
                         f"{tuple(part_dists.shape)} and {pair_dists.dtype} "
                         f"{tuple(pair_dists.shape)}")
    n, lp, c1 = part_dists.shape
    if tuple(pair_dists.shape) != (lp, c1, c1):
        raise ValueError(f"line_codes: pair table {tuple(pair_dists.shape)} "
                         f"does not match distances {tuple(part_dists.shape)}")
    if lambda_bits not in (8, 16) or not 1 <= c1 <= LINE_CODES_MAX_C1:
        raise ValueError(f"line_codes: lambda_bits {lambda_bits} (8 or 16) "
                         f"and c1 {c1} (1 to {LINE_CODES_MAX_C1})")
    dev = part_dists.device
    if dev.type == "cpu" and pair_dists.device.type == "cpu":
        return linecodes.line_codes_plain(part_dists, pair_dists, lambda_bits)
    if dev.type != "cuda" or pair_dists.device != dev:
        raise ValueError(f"line_codes: expected CPU tensors or tensors on "
                         f"one CUDA device, got {dev} and "
                         f"{pair_dists.device}")
    if n * lp >= 2 ** 31:
        raise ValueError(f"line_codes: {n} x {lp} codes, above 2^31 - 1")
    codes = torch.empty((n, lp), dtype=torch.int64, device=dev)
    terms = torch.empty((n, lp), dtype=torch.float32, device=dev)
    if n == 0 or lp == 0:
        return codes, terms
    lib = build.load("linecodes")
    with torch.cuda.device(dev):
        err = lib.pqt_line_codes(_ptr(part_dists), _ptr(pair_dists), n, lp,
                                 c1, int(lambda_bits == 8), _ptr(codes),
                                 _ptr(terms), _stream(part_dists))
    build.check(err, "line_codes")
    line_codes.launches += 1
    return codes, terms


line_codes.launches = 0
