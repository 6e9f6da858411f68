"""Line re-rank from payload rows: hand-written CUDA kernel and plain version.

`rerank_fused` (kernel C, csrc/rerank.cu) replaces the TPU kernel
pqt_tpu/ops/pallas/rerank.py:rerank_fused.  It takes the gathered payload
rows row-major, (B, K, W) int32 as `payload[positions]` yields them, and the
query line tables (B, lp, c1) float32, and returns the reconstructed squared
distances (B, K).  On a CPU tensor it runs the plain version; on a CUDA
tensor it launches the kernel or raises.  The kernel decodes both payload
layouts, compact and wide, with the (lp, c1) table in shared memory (at
most RERANK_MAX_TABLE_BYTES).  `rerank_fused.launches` counts the launches,
`rerank_fused.wide_launches` those of the wide layout.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops import linecodes
from pqt_tpu_torch.ops.cuda import build
from pqt_tpu_torch.ops.cuda.primitives import _ptr, _stream

# A block's query table, lp * c1 float32 in shared memory (csrc/rerank.cu).
RERANK_MAX_TABLE_BYTES = 48 * 1024


def rerank_plain(rows: torch.Tensor, q_line: torch.Tensor,
                 compact: bool = True) -> torch.Tensor:
    """Unpack the rows, then reconstruct the distances."""
    _, a, b, lam, t3 = linecodes.unpack_payload_rows(
        rows, q_line.shape[1], compact)
    return linecodes.reconstruct_dists_idx(a, b, lam, q_line, t3)


def rerank_fused(rows: torch.Tensor, q_line: torch.Tensor,
                 compact: bool = True) -> torch.Tensor:
    """(B, K, W) payload rows x (B, lp, c1) line tables -> (B, K) distances.

    compact: the 16-bit-per-line-part layout (c1 <= 16, W = 2 + ceil(lp/2));
    otherwise the wide layout (c1 <= 256, W = 2 + lp).
    """
    B, K, W = rows.shape
    Bq, lp, c1 = q_line.shape
    want_w = 2 + ((lp + 1) // 2 if compact else lp)
    if Bq != B or W != want_w or c1 > (16 if compact else 256):
        raise ValueError(f"rerank_fused: rows {tuple(rows.shape)} and tables "
                         f"{tuple(q_line.shape)} do not match (compact="
                         f"{compact})")
    if rows.device.type == "cpu":
        return rerank_plain(rows, q_line, compact)
    if lp * c1 * 4 > RERANK_MAX_TABLE_BYTES:
        raise NotImplementedError(
            f"rerank_fused: a ({lp}, {c1}) table exceeds the kernel's "
            f"{RERANK_MAX_TABLE_BYTES} bytes of shared memory")
    if (rows.device.type != "cuda" or q_line.device != rows.device
            or rows.dtype != torch.int32 or q_line.dtype != torch.float32
            or not rows.is_contiguous() or not q_line.is_contiguous()):
        raise ValueError("rerank_fused: expected contiguous int32 rows and "
                         "float32 tables on one CUDA device")
    if B > 65535:
        raise ValueError("rerank_fused: at most 65535 queries per call")
    out = torch.empty((B, K), dtype=torch.float32, device=rows.device)
    if B == 0 or K == 0:
        return out
    lib = build.load("rerank")
    with torch.cuda.device(rows.device):
        err = lib.pqt_rerank_fused(_ptr(rows), _ptr(q_line), B, K, W, lp, c1,
                                   int(compact), _ptr(out), _stream(rows))
    build.check(err, "rerank_fused")
    rerank_fused.launches += 1
    rerank_fused.wide_launches += not compact
    return out


rerank_fused.launches = 0
rerank_fused.wide_launches = 0
