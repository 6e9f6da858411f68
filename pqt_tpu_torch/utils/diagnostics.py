"""Build and query diagnostics: ground-truth bin probes, quantization stats.

Port of pqt_tpu/utils/diagnostics.py:

  * `ground_truth_bins`: the bin each ground-truth vector lands in, cached
    on disk (the reference's .gtBins file);
  * `gt_bin_probe_positions`: where in the query pipeline's enumeration a
    query's ground-truth bin comes, which tells "the probe misses the bin"
    from "the re-rank loses the vector";
  * `quantization_stats`: the line-code distance model's error against
    exact distances on a sample, with the u16 and u8 lambda codecs apart,
    and the range of lambda used.

Each runs on the device of the tree's tensors.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.db import encode_bins, encode_line_codes
from pqt_tpu_torch.models.tree import PQTree, line_tables
from pqt_tpu_torch.ops.distance import subpart_sqdist_terms
from pqt_tpu_torch.ops.linecodes import (best_lines, build_line_codes,
                                         reconstruct_dists_idx, unpack_codes)


def _on_tree(tree: PQTree, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=tree.cb1.device)


def ground_truth_bins(cfg: PQTConfig, tree: PQTree, gt_vectors,
                      cache_path: Optional[str] = None) -> np.ndarray:
    """Bin slot id (n,) int32 of each ground-truth vector; with
    `cache_path`, loaded from that .npy file when it holds as many rows,
    else computed and saved there."""
    n = np.asarray(gt_vectors).shape[0]
    if cache_path and os.path.exists(cache_path):
        cached = np.load(cache_path)
        if cached.shape[0] == n:
            return cached
    bins = encode_bins(cfg, tree, _on_tree(tree, gt_vectors)).cpu().numpy()
    if cache_path:
        np.save(cache_path, bins)
    return bins


def gt_bin_probe_positions(cfg: PQTConfig, tree: PQTree, queries,
                           gt_bins: np.ndarray) -> np.ndarray:
    """(B,) int32: the index in the enumeration order (before the
    occupancy compaction) at which each query's ground-truth bin comes, or
    -1 when it is not enumerated within the budget."""
    from pqt_tpu_torch.models import query as Q

    q = _on_tree(tree, queries)
    if cfg.pair_pipeline_enabled:
        _, h_pairs, exact = Q._pair_stage(cfg, tree, q)
        bins = Q._enumerate_bins_pair(cfg, h_pairs, exact)
    else:
        sorted_d2, sorted_codes = Q._sorted_part_lists(cfg, tree, q)
        E = cfg.effective_enum_width
        # every bin counts as occupied, so nothing is compacted away
        ones = torch.ones((cfg.hash_size,), dtype=torch.int32,
                          device=q.device)
        bins, _ = Q._enumerate_bins(
            cfg.replace(max_bins=E, bin_enum_factor=1), sorted_d2,
            sorted_codes, ones)
    bins = bins.cpu().numpy()
    hit = bins == np.asarray(gt_bins, bins.dtype)[:bins.shape[0], None]
    return np.where(hit.any(axis=1), hit.argmax(axis=1), -1).astype(np.int32)


def _line_dists(codes, q_line, t3):
    """Line-model distances of each vector to its own pseudo-query."""
    a, b, lam = unpack_codes(codes[:, None, :])
    return reconstruct_dists_idx(a, b, lam, q_line, t3[:, None])[:, 0]


def quantization_stats(cfg: PQTConfig, tree: PQTree,
                       sample_vectors) -> Dict[str, float]:
    """Relative error (min, max, mean) of the line-code distances against
    exact distances over a sample, each vector against the next one as its
    query, normalised by the mean exact distance; the same for the
    unquantized line model and the u16 and u8 lambda codecs; and the
    lambda range of the stored codes."""
    x = np.asarray(sample_vectors, np.float32)
    n = x.shape[0]
    q = x[(np.arange(n) + 1) % n]
    xt, qt = _on_tree(tree, x), _on_tree(tree, q)
    codes, t3 = encode_line_codes(cfg, tree, xt)
    q_line = line_tables(cfg, tree, qt)                    # (n, lp, c1)
    approx = _line_dists(codes, q_line, t3).cpu().numpy()
    exact = ((q - x) ** 2).sum(axis=1)
    scale = max(float(exact.mean()), 1e-6)
    rel = np.abs(approx - exact) / scale
    lam_u16 = ((codes >> 16) & 0xFFFF).cpu().numpy()
    lam = lam_u16.astype(np.float32) / 8192.0 - 4.0

    ld = line_tables(cfg, tree, xt)
    a_i, b_i, lam_c, c2_b = best_lines(ld, tree.pair_dists)
    t3_c = torch.sum((lam_c * lam_c - lam_c) * c2_b, dim=-1)
    model = reconstruct_dists_idx(a_i[:, None, :], b_i[:, None, :],
                                  lam_c[:, None, :], q_line,
                                  t3_c[:, None])[:, 0].cpu().numpy()
    out = {"rel_err_model": float((np.abs(model - exact) / scale).mean())}
    terms = subpart_sqdist_terms(xt, tree.centroids_full, cfg.line_parts)
    for name, bits in (("codec16", 16), ("codec8", 8)):
        ci, ti = build_line_codes(*terms, tree.pair_dists, lambda_bits=bits)
        ai = _line_dists(ci, q_line, ti).cpu().numpy()
        out[f"rel_err_{name}"] = float((np.abs(ai - exact) / scale).mean())
    return {
        "rel_err_mean": float(rel.mean()),
        "rel_err_max": float(rel.max()),
        "rel_err_min": float(rel.min()),
        **out,
        "lambda_min": float(lam.min()),
        "lambda_max": float(lam.max()),
        "lambda_mean": float(lam.mean()),
        "n_sample": int(n),
    }
