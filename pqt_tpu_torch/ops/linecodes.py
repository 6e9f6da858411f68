"""Line-quantization codes: build, pack, unpack, and distance reconstruction.

Port of pqt_tpu/ops/linecodes.py.  Each database vector stores, per line
part, the line between two L1 centroid segments (A, B) its segment projects
onto, and the projection fraction lambda.  A packed code is the uint32
A | B << 8 | lambda_u16 << 16, held here in an int64 tensor (torch's uint32
arithmetic is patchy on CUDA); the values equal the JAX package's codes.

`reconstruct_dists_idx` is the plain version of kernel C
(ops/cuda/rerank.py), which computes the same distances from payload rows.
"""

from __future__ import annotations

import torch

from pqt_tpu_torch.ops import triangle


def pack_codes(a, b, lam_u16) -> torch.Tensor:
    """(A, B, lambda_u16) -> packed uint32 values in an int64 tensor."""
    return (a.to(torch.int64) | (b.to(torch.int64) << 8)
            | (lam_u16.to(torch.int64) << 16))


def unpack_codes(packed: torch.Tensor):
    """Packed codes (int64 values, or int32 bit patterns) -> (A int32,
    B int32, lambda float32)."""
    u = packed.to(torch.int64) & 0xFFFFFFFF
    a = (u & 0xFF).to(torch.int32)
    b = ((u >> 8) & 0xFF).to(torch.int32)
    return a, b, triangle.u16_to_lambda((u >> 16) & 0xFFFF)


def best_lines(part_dists: torch.Tensor, pair_dists: torch.Tensor):
    """The unquantized line selection: over ordered pairs A < B, the line
    with the smallest projection residual b2 - lambda^2 * c2 (first minimum
    on ties).

    part_dists: (n, lp, c1) vector-segment to centroid-segment distances;
    pair_dists: (lp, c1, c1).  Returns (best_a, best_b (n, lp) int32,
    lam_best (n, lp) continuous lambda, c2_best (n, lp) pair distance).
    """
    n, lp, c1 = part_dists.shape
    a2 = part_dists[:, :, None, :]            # distance to B (last axis)
    b2 = part_dists[:, :, :, None]            # distance to A
    c2 = pair_dists[None, :, :, :]
    lam, resid = triangle.project_with_residual(a2, b2, c2)
    upper = torch.ones((c1, c1), dtype=torch.bool,
                       device=part_dists.device).triu(1)
    resid = torch.where(upper, resid, float("inf"))
    best = torch.argmin(resid.reshape(n, lp, c1 * c1), dim=-1)   # (n, lp)
    lam_best = torch.gather(lam.reshape(n, lp, c1 * c1), 2,
                            best[..., None])[..., 0]
    c2_best = torch.gather(pair_dists.reshape(1, lp, c1 * c1)
                           .expand(n, lp, c1 * c1), 2, best[..., None])[..., 0]
    best = best.to(torch.int32)
    return best // c1, best % c1, lam_best, c2_best


def build_line_codes(part_dists: torch.Tensor, pair_dists: torch.Tensor,
                     lambda_bits: int = 16):
    """Best (A, B, lambda) per (vector, line part).

    Returns (packed (n, lp) codes -- lambda on the u16 grid whatever the
    width, so `unpack_codes` always applies -- and t3 (n,) float32, the
    query-independent term sum_lp (lambda^2 - lambda) * pair[lp, A, B]
    computed from the DECODED lambda, so build and query agree).
    """
    best_a, best_b, lam_best, c2_best = best_lines(part_dists, pair_dists)
    if lambda_bits == 8:
        lam_u16 = triangle.lambda_to_u8(lam_best) << 8
    else:
        lam_u16 = triangle.lambda_to_u16(lam_best)
    packed = pack_codes(best_a, best_b, lam_u16)
    lam_q = triangle.u16_to_lambda(lam_u16)
    t3 = torch.sum((lam_q * lam_q - lam_q) * c2_best, dim=-1)
    return packed, t3


def unpack_payload_rows(rows: torch.Tensor, line_parts: int, compact: bool):
    """Payload rows (..., W) int32 -> (ids, A, B (..., lp) int32,
    lambda (..., lp) float32, t3 (...,) float32).

    Layout (models/db.py): column 0 the id, column 1 t3's float bits, then
    either one wide code per line part, or (compact) two 16-bit parts per
    column, A | B << 4 | lambda_u8 << 8, low half first.
    """
    ids = rows[..., 0]
    t3 = rows[..., 1].contiguous().view(torch.float32)
    words = rows[..., 2:].to(torch.int64) & 0xFFFFFFFF
    if not compact:
        a, b, lam = unpack_codes(words)
        return ids, a, b, lam, t3
    part16 = torch.stack([words & 0xFFFF, words >> 16], dim=-1).reshape(
        rows.shape[:-1] + (2 * words.shape[-1],))[..., :line_parts]
    a = (part16 & 0xF).to(torch.int32)
    b = ((part16 >> 4) & 0xF).to(torch.int32)
    lam = triangle.u8_to_lambda((part16 >> 8) & 0xFF)
    return ids, a, b, lam, t3


def reconstruct_dists_idx(a_idx, b_idx, lam, query_part_dists, t3):
    """Approximate squared distances from unpacked line codes.

    a_idx, b_idx: (B, K, lp) int; lam: (B, K, lp); query_part_dists:
    (B, lp, c1); t3: (B, K).  Per line part the triangle identity gives
    (1 - lam) * q[lp, A] + lam * q[lp, B] + (lam^2 - lam) * pair[lp, A, B],
    whose last term is the stored t3.  Returns (B, K) float32.
    """
    Bq, K, lp = a_idx.shape
    c1 = query_part_dists.shape[-1]
    q = query_part_dists[:, None, :, :].expand(Bq, K, lp, c1)
    qa = torch.gather(q, 3, a_idx.to(torch.int64)[..., None])[..., 0]
    qb = torch.gather(q, 3, b_idx.to(torch.int64)[..., None])[..., 0]
    acc = (1.0 - lam) * qa + lam * qb
    return torch.sum(acc, dim=-1) + t3
