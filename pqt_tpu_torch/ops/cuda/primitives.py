"""Row top-k, row prefix sum and segment sums: hand-written CUDA kernels
and plain versions.

`bitonic_topk` (kernel A, csrc/topk.cu), `block_scan` (kernel B,
csrc/scan.cu) and `segmented_reduce` (kernel D, csrc/reduce.cu) replace the
TPU kernels of the same names in pqt_tpu/ops/pallas/primitives.py.  On a
CPU tensor each wrapper runs its plain PyTorch version; on a CUDA tensor it
launches its kernel or raises.
Each wrapper counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import ctypes

import torch

from pqt_tpu_torch.ops.cuda import build

# Longest row kernel A sorts in one block: 8 bytes an element in shared
# memory, 128 KB at 16384 (a Hopper block may take 227 KB).
TOPK_MAX_ROW = 16384
# Rows longer than this take the three-pass long-row scan.
SCAN_ROWS_MAX = 16384


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_input(x: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 2-D {dtype} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")


def bitonic_topk_plain(x: torch.Tensor, k: int):
    """Per-row k smallest values, ascending, ties lowest index first."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def bitonic_topk(x: torch.Tensor, k: int):
    """Per-row smallest-k (values, int32 indices) of a (B, N) float32 array.

    Values come out ascending and ties lowest index first, like `lax.top_k`
    of the negated row and a stable ascending sort.  Inputs must not be NaN.
    On the card a row may hold up to TOPK_MAX_ROW elements, any N below it.
    """
    B, N = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"bitonic_topk: k={k} outside [1, {N}]")
    if x.device.type == "cpu":
        return bitonic_topk_plain(x, k)
    _check_input(x, torch.float32, "bitonic_topk")
    if N > TOPK_MAX_ROW:
        raise NotImplementedError(
            f"bitonic_topk: rows of {N} > {TOPK_MAX_ROW} elements, such as "
            "SIFT1B_CONFIG's (k1_query * c2)^2 = 65536 pair grid, come with "
            "the slice that serves SIFT1B (ROADMAP.md queue 1)")
    out_v = torch.empty((B, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return out_v, out_i
    lib = build.load("topk")
    with torch.cuda.device(x.device):
        err = lib.pqt_bitonic_topk(_ptr(x), B, N, k, _ptr(out_v),
                                   _ptr(out_i), _stream(x))
    build.check(err, "bitonic_topk")
    bitonic_topk.launches += 1
    return out_v, out_i


bitonic_topk.launches = 0


def block_scan_plain(x: torch.Tensor, exclusive: bool = False):
    """Per-row int32 prefix sum (inclusive, or exclusive)."""
    s = torch.cumsum(x, dim=-1, dtype=torch.int32)
    return s - x if exclusive else s


def block_scan(x: torch.Tensor, exclusive: bool = False):
    """Per-row prefix sums of a (B, N) int32 array, int32 out.

    The sum of each row must fit in int32.  Rows up to SCAN_ROWS_MAX run
    one block per row; longer rows (the build's CSR prefix) run the
    three-pass long-row scan.
    """
    if x.device.type == "cpu":
        return block_scan_plain(x, exclusive)
    _check_input(x, torch.int32, "block_scan")
    B, N = x.shape
    out = torch.empty_like(x)
    if B == 0 or N == 0:
        return out
    lib = build.load("scan")
    with torch.cuda.device(x.device):
        if N <= SCAN_ROWS_MAX:
            err = lib.pqt_block_scan_rows(_ptr(x), B, N, int(exclusive),
                                          _ptr(out), _stream(x))
        else:
            tiles = -(-N // lib.pqt_scan_tile())
            sums = torch.empty((B, tiles), dtype=torch.int32, device=x.device)
            offsets = torch.empty_like(sums)
            err = lib.pqt_block_scan_long(_ptr(x), B, N, int(exclusive),
                                          _ptr(sums), _ptr(offsets),
                                          _ptr(out), _stream(x))
    build.check(err, "block_scan")
    block_scan.launches += 1
    return out


block_scan.launches = 0


def segmented_reduce_plain(x: torch.Tensor, parts: int) -> torch.Tensor:
    """Per-row sums over `parts` equal contiguous segments."""
    B, D = x.shape
    return x.reshape(B, parts, D // parts).sum(-1)


def segmented_reduce(x: torch.Tensor, parts: int) -> torch.Tensor:
    """(B, D) float32 -> (B, parts) float32: the sum of each of the `parts`
    equal contiguous segments of every row (D % parts == 0, any D)."""
    B, D = x.shape
    if parts < 1 or D % parts:
        raise ValueError(f"segmented_reduce: D={D} is not a multiple of "
                         f"parts={parts}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("segmented_reduce: expected a contiguous float32 "
                         f"tensor, got {x.dtype}")
    if x.device.type == "cpu":
        return segmented_reduce_plain(x, parts)
    _check_input(x, torch.float32, "segmented_reduce")
    if B == 0 or D == 0:
        return torch.zeros((B, parts), dtype=torch.float32, device=x.device)
    out = torch.empty((B, parts), dtype=torch.float32, device=x.device)
    lib = build.load("reduce")
    with torch.cuda.device(x.device):
        err = lib.pqt_segmented_reduce(_ptr(x), B * parts, D // parts,
                                       _ptr(out), _stream(x))
    build.check(err, "segmented_reduce")
    segmented_reduce.launches += 1
    return out


segmented_reduce.launches = 0
