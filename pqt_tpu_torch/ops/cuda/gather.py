"""Table lookups and row gathers: hand-written CUDA kernels and plain versions.

`lut_gather` (csrc/lut.cu) is the counterpart of three TPU kernels that
compute one function, out[b, e] = table[idx[b, e]]: `pallas_gather`
(benchmarks/micro_gather.py) and `pallas_lut_2d` and `pallas_lut_onehot`
(benchmarks/micro_gather2.py).  `gather_rows` (csrc/gather.cu) replaces
`pallas_dma_gather` (benchmarks/micro_gather2.py), out[b, k, :] =
tab[pos[b, k], :], and adds slab mode: `span` consecutive rows from each
position.  Its launch shape comes from `_gather_plan`, a pure-Python plan
the CPU tests check.

On CPU tensors each wrapper runs its plain PyTorch version; on CUDA tensors
it launches its kernel or raises.  Tables and indices must be contiguous,
the indices int32 and inside the table (the plain versions raise on one
that is not; the kernels read nothing for it and yield zeros).  Each
wrapper counts its launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _on_cpu, _ptr, _stream


def lut_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def lut_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (H,) int32 (occupancy counts, CSR starts) or uint8 (pair
    occupancy), idx int32 of any shape -> table[idx], shaped like idx."""
    if table.dim() != 1 or table.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"lut_gather: expected a 1-D int32 or uint8 table, "
                         f"got {table.dtype} {tuple(table.shape)}")
    if _on_cpu(table, idx, "lut_gather"):
        return lut_gather_plain(table, idx)
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    if idx.numel() == 0:
        return out
    lib = build.load("lut")
    with torch.cuda.device(table.device):
        err = lib.pqt_lut_gather(_ptr(table), table.shape[0],
                                 table.element_size(), _ptr(idx), idx.numel(),
                                 _ptr(out), _stream(table))
    build.check(err, "lut_gather")
    lut_gather.launches += 1
    return out


lut_gather.launches = 0


# Kernel H's launch shape (csrc/gather.cu).  An item is one position: its
# `span` rows, contiguous in the table and in the output, copied in units of
# the widest of GATHER_UNITS bytes that divides the row and to which table
# and output are aligned.  Items of at most GATHER_GROUP_MAX units take rows
# mode: a group of `units` lanes an item, GATHER_ROWS items in flight a
# group, one tile a block.  Longer items take long mode: a warp an item,
# GATHER_ROWS units a lane in flight, a grid-stride loop over at most
# GATHER_LONG_BLOCKS blocks.  GATHER_ROWS is fixed in csrc/gather.cu.
GATHER_THREADS = 256
GATHER_UNITS = (16, 8, 4, 2, 1)
GATHER_GROUP_MAX = 32
GATHER_ROWS = 4
GATHER_LONG_BLOCKS = 1 << 16
GATHER_ITEMS_MAX = (1 << 31) - 1 - (1 << 20)


class GatherPlan(NamedTuple):
    """How kernel H runs a gather of n_pos items."""
    mode: str      # "rows" (a group of `units` lanes an item, 32 // units
                   # groups a warp) or "long" (a warp an item)
    unit: int      # bytes a load or store moves
    units: int     # units an item: span * row_bytes / unit
    rows: int      # items a group has in flight (rows mode), units a lane
                   # has in flight (long mode)
    blocks: int    # blocks of GATHER_THREADS threads


def _gather_plan(n_pos: int, row_bytes: int, span: int,
                 addr: int) -> GatherPlan:
    """Kernel H's mode and launch shape for n_pos >= 1 items of `span` rows
    of row_bytes bytes; `addr` is the table's address OR-ed with the
    output's (only its low bits count: the unit must divide both).  Raises
    ValueError for an empty shape, NotImplementedError beyond
    GATHER_ITEMS_MAX items or 2^31 units an item."""
    if n_pos < 1 or row_bytes < 1 or span < 1:
        raise ValueError(f"gather_rows: empty shape ({n_pos} items of "
                         f"{span} x {row_bytes} bytes)")
    unit = next(v for v in GATHER_UNITS if row_bytes % v == 0 and addr % v == 0)
    units = span * row_bytes // unit
    if n_pos > GATHER_ITEMS_MAX or units >= 1 << 31:
        raise NotImplementedError(
            f"gather_rows: {n_pos} items of {units} units (at most "
            f"{GATHER_ITEMS_MAX} items of fewer than 2^31 units)")
    if units <= GATHER_GROUP_MAX:
        per_block = GATHER_THREADS // 32 * (32 // units) * GATHER_ROWS
        return GatherPlan("rows", unit, units, GATHER_ROWS,
                          -(-n_pos // per_block))
    return GatherPlan("long", unit, units, GATHER_ROWS,
                      min(GATHER_LONG_BLOCKS,
                          -(-n_pos // (GATHER_THREADS // 32))))


def gather_rows_plain(tab: torch.Tensor, pos: torch.Tensor,
                      span: int = 1) -> torch.Tensor:
    p = pos.long()
    if span == 1:
        return tab[p]
    return tab[p[..., None] + torch.arange(span, device=pos.device)]


def gather_rows(tab: torch.Tensor, pos: torch.Tensor,
                span: int = 1) -> torch.Tensor:
    """tab (N, W) of any dtype, pos int32 of any shape -> the rows tab[pos]
    (pos.shape + (W,)); with span > 1, the `span` rows from each position
    on (pos.shape + (span, W)), which must all lie inside the table.  On
    the card the kernel runs in the mode `_gather_plan` picks."""
    if tab.dim() != 2 or span < 1:
        raise ValueError(f"gather_rows: expected a 2-D table and span >= 1, "
                         f"got {tuple(tab.shape)} and span={span}")
    if _on_cpu(tab, pos, "gather_rows"):
        return gather_rows_plain(tab, pos, span)
    N, W = tab.shape
    shape = tuple(pos.shape) + ((span,) if span > 1 else ()) + (W,)
    out = torch.empty(shape, dtype=tab.dtype, device=tab.device)
    if out.numel() == 0:
        return out
    row_bytes = W * tab.element_size()
    plan = _gather_plan(pos.numel(), row_bytes, span,
                        tab.data_ptr() | out.data_ptr())
    lib = build.load("gather")
    with torch.cuda.device(tab.device):
        err = lib.pqt_gather_rows(_ptr(tab), N, row_bytes, _ptr(pos),
                                  pos.numel(), span, plan.unit, plan.blocks,
                                  _ptr(out), _stream(tab))
    build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
