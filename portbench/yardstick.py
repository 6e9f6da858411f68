"""The yardstick: the card's peaks, the least time of a kernel's work, and
the recall arithmetic.

Frozen copies, so that a change to the port cannot move them: the
published H100 SXM peaks and `bound` of chip_smoke.py, kernel L's byte and
operation counts of chip_smoke.py's kernel checks, and `intersection_at`
of pqt_tpu_torch/utils/metrics.py (numpy only).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit): HBM
# bytes/s and float32 (non-tensor) operations/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def bound(bytes_moved: float, ops: float):
    """(least seconds, what bounds it) at the card's published peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def line_codes_bound_s(rows: int, line_parts: int, c1: int) -> float:
    """Least seconds of kernel L over one encode chunk: the (rows, lp, c1)
    float32 tables and the (lp, c1, c1) pair table read once, an int64
    code and a float32 term written a (row, part); 8 operations a pair
    A < B (two subtractions, a multiply, a divide, two multiplies, a
    subtraction, a compare)."""
    pairs = rows * line_parts * c1 * (c1 - 1) // 2
    return bound(rows * line_parts * c1 * 4 + line_parts * c1 * c1 * 4
                 + rows * line_parts * 12, 8 * pairs)[0]


def exact_rerank_bytes(valid_candidates: int, queries: int, dim: int,
                       row_bytes: int) -> int:
    """Least bytes of the exact re-rank's distances: every valid
    candidate's raw row and its int32 id read once and its float32
    distance written once, and each float32 query read once."""
    return valid_candidates * (row_bytes + 4 + 4) + queries * dim * 4


def intersection_at(result_ids: np.ndarray, gt_ids: np.ndarray,
                    ks: Sequence[int] = (10, 100)) -> Dict[str, float]:
    """Top-k intersection: |result[:k] ∩ gt[:k]| / k averaged over
    queries."""
    result_ids = np.asarray(result_ids)
    gt_ids = np.asarray(gt_ids)
    out = {}
    for k in ks:
        k_eff = min(k, result_ids.shape[1], gt_ids.shape[1])
        inter = [
            len(np.intersect1d(result_ids[i, :k_eff], gt_ids[i, :k_eff]))
            for i in range(result_ids.shape[0])
        ]
        out[f"top{k}_intersection"] = float(np.mean(inter) / k_eff)
    return out
