"""Line re-rank from the payload: hand-written CUDA kernel and plain version.

Kernel C (csrc/rerank.cu) replaces the TPU kernel
pqt_tpu/ops/pallas/rerank.py:rerank_fused and, on every line re-rank, the
payload-row gather in front of it (kernel H): `gather_rerank` reads each
candidate's payload row once, through its CSR position, and writes the
candidate's id and its line distance to the query, +inf where the slot is
invalid.  `rerank_fused` keeps the Pallas kernel's contract, rows already
gathered into (B, K, W), and runs the same kernel over them as a payload of
B * K rows.  Both decode the compact and the wide payload layout, with any
(lp, c1) table: up to 227 KB in shared memory, larger ones from global
memory.  The launch shape comes from `_rerank_plan`, a pure-Python plan
the CPU tests check.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches the kernel or raises.  `rerank_fused.launches` counts every launch
of kernel C, through either wrapper, `rerank_fused.wide_launches` those of
the wide layout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from pqt_tpu_torch.ops import linecodes
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _on_cpu, _ptr, _stream

# Kernel C's launch shape (csrc/rerank.cu).  A tile is RERANK_THREADS
# candidates of one query, one a thread; a block walks a run of a query's
# tiles with the table loaded once.  Staged rows are double-buffered in
# shared memory ([2][256][W] int32 rows and [2][256] positions), copied in
# the widest of RERANK_UNITS bytes that divides the row and the payload's
# address.  A block takes at most RERANK_SMEM_MAX bytes of shared memory
# (the H100's opt-in limit); an SM has RERANK_SM_SMEM bytes for its blocks,
# RERANK_SM_RESERVED of them reserved a block, and at most
# RERANK_BLOCKS_PER_SM blocks of 256 threads.
RERANK_THREADS = 256
RERANK_UNITS = (16, 8, 4)
RERANK_SMEM_MAX = 232448
RERANK_SM_SMEM = 233472
RERANK_SM_RESERVED = 1024
RERANK_BLOCKS_PER_SM = 2048 // RERANK_THREADS
RERANK_POSITIONS_MAX = (1 << 31) - 1


class RerankPlan(NamedTuple):
    """How kernel C runs a re-rank of (B, K) candidates."""
    staged: bool       # rows double-buffered in shared memory (else each
                       # thread reads its row from global memory)
    unit: int          # bytes a staged copy moves
    table_smem: bool   # the (lp, c1) table in shared memory (else global)
    smem: int          # bytes of dynamic shared memory a block
    chunks: int        # blocks a query
    per_chunk: int     # tiles a block (the last block of a query may have
                       # fewer)


def _rerank_plan(B: int, K: int, W: int, lp: int, c1: int, addr: int,
                 sms: int) -> RerankPlan:
    """Kernel C's launch shape for B >= 1 queries of K >= 1 candidates of
    W-word rows and (lp, c1) tables, on a card of `sms` SMs; `addr` is the
    payload's address (only its low bits count: the unit must divide it).
    The rows are staged when two buffers of 256 fit, the table is shared
    when it fits beside them, and a query gets as many blocks as the SMs
    hold resident at once over B, at most one a tile."""
    if B < 1 or K < 1 or W < 3 or lp < 1 or c1 < 1 or sms < 1:
        raise ValueError(f"gather_rerank: empty shape ({B}, {K}) x {W} "
                         f"words, table ({lp}, {c1}), {sms} SMs")
    row_bytes = 4 * W
    unit = next(v for v in RERANK_UNITS
                if row_bytes % v == 0 and addr % v == 0)
    staging = 2 * RERANK_THREADS * (row_bytes + 4)
    staged = staging <= RERANK_SMEM_MAX
    smem = staging if staged else 0
    table = 4 * lp * c1
    table_smem = smem + table <= RERANK_SMEM_MAX
    smem += table if table_smem else 0
    per_sm = min(RERANK_BLOCKS_PER_SM,
                 RERANK_SM_SMEM // (smem + RERANK_SM_RESERVED))
    tiles = -(-K // RERANK_THREADS)
    per_chunk = -(-tiles // max(1, min(tiles, sms * per_sm // B)))
    return RerankPlan(staged, unit, table_smem, smem,
                      -(-tiles // per_chunk), per_chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rerank_plain(rows: torch.Tensor, q_line: torch.Tensor,
                 compact: bool = True) -> torch.Tensor:
    """Unpack the rows, then reconstruct the distances."""
    _, a, b, lam, t3 = linecodes.unpack_payload_rows(
        rows, q_line.shape[1], compact)
    return linecodes.reconstruct_dists_idx(a, b, lam, q_line, t3)


def gather_rerank_plain(payload: torch.Tensor, positions: torch.Tensor,
                        valid: torch.Tensor, q_line: torch.Tensor,
                        compact: bool = True):
    """rerank_plain over payload[positions], with the id column and +inf
    where invalid; a position outside the payload gives id 0 and +inf."""
    p = positions.long()
    inside = (p >= 0) & (p < payload.shape[0])
    rows = payload[torch.where(inside, p, 0)]
    ids = torch.where(inside, rows[..., 0], 0)
    dists = torch.where(valid & inside, rerank_plain(rows, q_line, compact),
                        float("inf"))
    return ids, dists


def _check_tables(what: str, B: int, W: int, q_line: torch.Tensor,
                  compact: bool) -> None:
    if q_line.dim() != 3 or q_line.dtype != torch.float32 or \
            not q_line.is_contiguous():
        raise ValueError(f"{what}: expected contiguous (B, lp, c1) float32 "
                         f"tables, got {q_line.dtype} {tuple(q_line.shape)}")
    Bq, lp, c1 = q_line.shape
    if Bq != B or W != 2 + ((lp + 1) // 2 if compact else lp) or \
            c1 > (16 if compact else 256):
        raise ValueError(f"{what}: {W}-word rows of {B} queries and tables "
                         f"{tuple(q_line.shape)} do not match (compact="
                         f"{compact})")


def _launch(payload, positions, valid, q_line, compact, B, K):
    """Kernel C over (B, K) candidates of `payload` (positions and valid
    None: rows b * K + k, all valid) -> (ids, dists)."""
    N, W = payload.shape
    _, lp, c1 = q_line.shape
    dev = payload.device
    if q_line.device != dev or any(
            t is not None and t.device != dev for t in (positions, valid)):
        raise ValueError("gather_rerank: expected every tensor on one CUDA "
                         "device")
    if N > RERANK_POSITIONS_MAX:
        raise ValueError(f"gather_rerank: {N} payload rows (int32 positions "
                         f"reach {RERANK_POSITIONS_MAX})")
    ids = torch.empty((B, K), dtype=torch.int32, device=dev)
    dists = torch.empty((B, K), dtype=torch.float32, device=dev)
    if B == 0 or K == 0:
        return ids, dists
    plan = _rerank_plan(B, K, W, lp, c1, payload.data_ptr(),
                        _sm_count(dev.index))
    lib = build.load("rerank")
    with torch.cuda.device(dev):
        err = lib.pqt_gather_rerank(
            _ptr(payload), N, W, None if positions is None else
            _ptr(positions), None if valid is None else _ptr(valid), B, K,
            _ptr(q_line), lp, c1, int(compact), int(plan.staged),
            int(plan.table_smem), plan.unit, plan.smem, plan.chunks,
            plan.per_chunk, _ptr(ids), _ptr(dists), _stream(payload))
    build.check(err, "gather_rerank")
    rerank_fused.launches += 1
    rerank_fused.wide_launches += not compact
    return ids, dists


def gather_rerank(payload: torch.Tensor, positions: torch.Tensor,
                  valid: torch.Tensor, q_line: torch.Tensor,
                  compact: bool = True):
    """The line re-rank of candidates read by position: payload (N, W)
    int32 rows, positions (B, K) int32 rows of it, valid (B, K) bool,
    q_line (B, lp, c1) float32 line tables -> (ids (B, K) int32,
    payload[positions, 0]; dists (B, K) float32, +inf where invalid).

    compact: the 16-bit-per-line-part layout (c1 <= 16, W = 2 +
    ceil(lp/2)); otherwise the wide layout (c1 <= 256, W = 2 + lp).  The
    row is read whatever `valid` says, so an invalid slot's id is that of
    the row at its position; callers pass positions inside the payload (a
    position outside it gives id 0 and +inf).
    """
    if payload.dim() != 2 or payload.dtype != torch.int32 or \
            positions.dim() != 2:
        raise ValueError(f"gather_rerank: expected a 2-D int32 payload and "
                         f"(B, K) positions, got {payload.dtype} "
                         f"{tuple(payload.shape)} and "
                         f"{tuple(positions.shape)}")
    B, K = positions.shape
    if valid.dtype != torch.bool or tuple(valid.shape) != (B, K) or \
            not valid.is_contiguous():
        raise ValueError(f"gather_rerank: expected contiguous ({B}, {K}) "
                         f"bool validity, got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    _check_tables("gather_rerank", B, payload.shape[1], q_line, compact)
    if _on_cpu(payload, positions, "gather_rerank"):
        if valid.device.type != "cpu" or q_line.device.type != "cpu":
            raise ValueError("gather_rerank: payload and positions on the "
                             "CPU, validity or tables elsewhere")
        return gather_rerank_plain(payload, positions, valid, q_line, compact)
    return _launch(payload, positions, valid, q_line, compact, B, K)


def rerank_fused(rows: torch.Tensor, q_line: torch.Tensor,
                 compact: bool = True) -> torch.Tensor:
    """(B, K, W) payload rows x (B, lp, c1) line tables -> (B, K) distances
    (the Pallas kernel's contract): kernel C over the rows as a payload of
    B * K rows, row b * K + k for candidate k of query b.

    compact: the 16-bit-per-line-part layout (c1 <= 16, W = 2 + ceil(lp/2));
    otherwise the wide layout (c1 <= 256, W = 2 + lp).
    """
    if rows.dim() != 3 or rows.dtype != torch.int32 or \
            not rows.is_contiguous():
        raise ValueError(f"rerank_fused: expected contiguous (B, K, W) int32 "
                         f"rows, got {rows.dtype} {tuple(rows.shape)}")
    B, K, W = rows.shape
    _check_tables("rerank_fused", B, W, q_line, compact)
    if rows.device.type == "cpu" and q_line.device.type == "cpu":
        return rerank_plain(rows, q_line, compact)
    if rows.device.type != "cuda":
        raise ValueError(f"rerank_fused: expected CPU or CUDA tensors, got "
                         f"{rows.device}")
    return _launch(rows.view(B * K, W), None, None, q_line, compact, B, K)[1]


rerank_fused.launches = 0
rerank_fused.wide_launches = 0
