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
from typing import NamedTuple, Optional

import torch

from pqt_tpu_torch.ops.cuda import build

# Kernel A's limits and its choice between modes (csrc/topk.cu).  One block
# sorts at most TOPK_SORT_MAX (value, index) pairs in shared memory (8 bytes
# a pair, 128 KB): the whole row in sort mode, the k survivors in select
# mode.  Select mode takes rows up to TOPK_SELECT_MAX_ROW elements, held in
# registers up to TOPK_SELECT_ITEMS[-1] x TOPK_SELECT_THREADS = 16384 and
# read again on every pass above that.
TOPK_SORT_MAX = 16384
TOPK_SELECT_MAX_ROW = 1 << 30
TOPK_SELECT_THREADS = 512
TOPK_SELECT_ITEMS = (4, 8, 16, 32)
TOPK_DIGIT_BITS = 8
# Rows of at most TOPK_SORT_ROW elements, and k above n / 2, sort the whole
# row: on the H100 the full sort beat the select's passes there, and lost
# to them on longer rows with k <= n / 2 (chip_smoke.py times both modes at
# every top-k shape; PERF.md).
TOPK_SORT_ROW = 512
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


class TopkPlan(NamedTuple):
    """How kernel A runs a (rows, n) -> k call."""
    mode: str       # "sort" (the whole row) or "select" (radix select + sort)
    items: int      # keys a select thread holds per tile (0 in sort mode)
    threads: int    # threads of a block (one block per row)
    sort_len: int   # pairs the block sorts: n or k, up to a power of two


def _pow2_at_least(v: int) -> int:
    return 1 << max(1, (v - 1).bit_length())


def _topk_plan(n: int, k: int, mode: Optional[str] = None) -> TopkPlan:
    """Kernel A's mode and launch shape for rows of n elements, k kept.

    Sort mode for rows of at most TOPK_SORT_ROW elements and for k above
    n / 2, select mode otherwise; `mode` forces one.  Raises
    NotImplementedError for what neither mode takes: a sort of more than
    TOPK_SORT_MAX elements, or a row longer than TOPK_SELECT_MAX_ROW.
    """
    if not 1 <= k <= n:
        raise ValueError(f"bitonic_topk: k={k} outside [1, {n}]")
    if mode is None:
        short = n <= TOPK_SORT_ROW or 2 * k > n
        mode = "sort" if short and n <= TOPK_SORT_MAX else "select"
    if mode == "sort":
        if n > TOPK_SORT_MAX:
            raise NotImplementedError(
                f"bitonic_topk: a sort of rows of {n} > {TOPK_SORT_MAX} "
                "elements")
        sort_len = _pow2_at_least(n)
        return TopkPlan("sort", 0, min(1024, sort_len // 2), sort_len)
    if mode != "select":
        raise ValueError(f"bitonic_topk: unknown mode {mode!r}")
    if k > TOPK_SORT_MAX or n > TOPK_SELECT_MAX_ROW:
        raise NotImplementedError(
            f"bitonic_topk: k={k} of rows of {n} elements (select mode keeps "
            f"k <= {TOPK_SORT_MAX} of rows up to {TOPK_SELECT_MAX_ROW})")
    items = next((i for i in TOPK_SELECT_ITEMS
                  if n <= i * TOPK_SELECT_THREADS), TOPK_SELECT_ITEMS[-1])
    needed = -(-n // items)                   # threads that hold the row
    threads = min(TOPK_SELECT_THREADS, 32 * -(-needed // 32))
    return TopkPlan("select", items, threads, _pow2_at_least(k))


def _topk_launch(x: torch.Tensor, k: int, plan: TopkPlan):
    """Launch kernel A on a contiguous (B, N) float32 CUDA tensor."""
    B, N = x.shape
    out_v = torch.empty((B, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return out_v, out_i
    lib = build.load("topk")
    with torch.cuda.device(x.device):
        err = lib.pqt_topk(_ptr(x), B, N, k, int(plan.mode == "select"),
                           plan.items, plan.threads, plan.sort_len,
                           _ptr(out_v), _ptr(out_i), _stream(x))
    build.check(err, "bitonic_topk")
    bitonic_topk.launches += 1
    return out_v, out_i


def bitonic_topk(x: torch.Tensor, k: int):
    """Per-row smallest-k (values, int32 indices) of a (B, N) float32 array.

    Values come out ascending and ties lowest index first, like `lax.top_k`
    of the negated row and a stable ascending sort (-0.0 and +0.0 equal, as
    in the sort).  Inputs must not be NaN.  On the card the kernel runs in
    the mode `_topk_plan` picks; any N up to TOPK_SELECT_MAX_ROW, with k up
    to TOPK_SORT_MAX where N is above that too.
    """
    _, N = x.shape
    plan = _topk_plan(N, k)
    if x.device.type == "cpu":
        return bitonic_topk_plain(x, k)
    _check_input(x, torch.float32, "bitonic_topk")
    return _topk_launch(x, k, plan)


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
