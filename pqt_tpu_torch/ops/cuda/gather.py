"""Table lookups and row gathers: hand-written CUDA kernels and plain versions.

`lut_gather` (csrc/lut.cu) is the counterpart of three TPU kernels that
compute one function, out[b, e] = table[idx[b, e]]: `pallas_gather`
(benchmarks/micro_gather.py) and `pallas_lut_2d` and `pallas_lut_onehot`
(benchmarks/micro_gather2.py).  `gather_rows` (csrc/gather.cu) replaces
`pallas_dma_gather` (benchmarks/micro_gather2.py), out[b, k, :] =
tab[pos[b, k], :], and adds slab mode: `span` consecutive rows from each
position.

On CPU tensors each wrapper runs its plain PyTorch version; on CUDA tensors
it launches its kernel or raises.  Tables and indices must be contiguous,
the indices int32 and inside the table (the plain versions raise on one
that is not; the kernels read nothing for it and yield zeros).  Each
wrapper counts its launches in its `launches` attribute.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _ptr, _stream


def _on_cpu(table: torch.Tensor, index: torch.Tensor, what: str) -> bool:
    """Check what the kernel takes, on any device (so the CPU runs catch a
    caller that would fail on the card); True for CPU tensors, which run
    the plain version."""
    if (not table.is_contiguous() or not index.is_contiguous()
            or index.dtype != torch.int32):
        raise ValueError(f"{what}: expected a contiguous table and contiguous "
                         f"int32 indices, got {table.dtype} (contiguous: "
                         f"{table.is_contiguous()}) and {index.dtype} "
                         f"(contiguous: {index.is_contiguous()})")
    if table.device.type == "cpu" and index.device.type == "cpu":
        return True
    if table.device.type != "cuda" or index.device != table.device:
        raise ValueError(f"{what}: expected CPU tensors or tensors on one "
                         f"CUDA device, got {table.device} and "
                         f"{index.device}")
    return False


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
    on (pos.shape + (span, W)), which must all lie inside the table."""
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
    lib = build.load("gather")
    with torch.cuda.device(tab.device):
        err = lib.pqt_gather_rows(_ptr(tab), N, W * tab.element_size(),
                                  _ptr(pos), pos.numel(), span, _ptr(out),
                                  _stream(tab))
    build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
