"""Recall metrics — the analyze() family.

A copy of the recall metrics of pqt_tpu/utils/metrics.py (numpy only), kept
here so the port imports nothing of the JAX package.

Equivalents of the reference's evaluation helpers:
  * recall metrics: test/testPPQT.cpp:46-141 (analyze), test/test1B.cpp:191-302;
  * CPU recall@{1,10,...}: cpu_version/tools/query.cpp:21-85;
  * bin occupancy: the binHist buckets (treequantizer.hpp:492-509).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def recall_at(result_ids: np.ndarray, gt_ids: np.ndarray,
              ks: Sequence[int] = (1, 10, 100)) -> Dict[str, float]:
    """R@k: fraction of queries whose true nearest neighbor (gt_ids[:, 0])
    appears in the first k results.  This is the standard SIFT1M metric and
    the reference's `foundBest` generalization (testPPQT.cpp:60-75)."""
    result_ids = np.asarray(result_ids)
    gt = np.asarray(gt_ids)[:, 0:1]
    out = {}
    for k in ks:
        k_eff = min(k, result_ids.shape[1])
        hit = (result_ids[:, :k_eff] == gt).any(axis=1)
        out[f"R@{k}"] = float(hit.mean())
    return out


def intersection_at(result_ids: np.ndarray, gt_ids: np.ndarray,
                    ks: Sequence[int] = (10, 100)) -> Dict[str, float]:
    """Top-k intersection percentage: |result[:k] ∩ gt[:k]| / k averaged over
    queries (testPPQT.cpp:77-120's top-10/top-100 numbers)."""
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


def candidate_recall(candidate_ids: np.ndarray,
                     candidate_valid: np.ndarray,
                     gt_ids: np.ndarray) -> float:
    """Fraction of queries whose true NN is anywhere in the candidate list —
    the upper bound any re-ranking can achieve (test1B.cpp's R_total sweep)."""
    gt = np.asarray(gt_ids)[:, 0]
    hits = 0
    for i in range(candidate_ids.shape[0]):
        c = candidate_ids[i][candidate_valid[i]]
        hits += int(gt[i] in c)
    return hits / candidate_ids.shape[0]



def occupancy_histogram(counts: np.ndarray) -> Dict[str, int]:
    """Bin-occupancy buckets (>1, >10, >100, >1k, >10k), the largest bin
    and the mean of the non-empty ones (the reference's binHist)."""
    counts = np.asarray(counts)
    nz = counts[counts > 0]
    return {
        "bins_nonempty": int(nz.size),
        "bins_gt1": int((nz > 1).sum()),
        "bins_gt10": int((nz > 10).sum()),
        "bins_gt100": int((nz > 100).sum()),
        "bins_gt1k": int((nz > 1000).sum()),
        "bins_gt10k": int((nz > 10000).sum()),
        "max_bin": int(nz.max()) if nz.size else 0,
        "mean_nonempty": float(nz.mean()) if nz.size else 0.0,
    }
