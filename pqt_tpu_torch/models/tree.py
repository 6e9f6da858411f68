"""Two-level product-quantization tree: codebooks, training, distance tables.

Port of pqt_tpu/models/tree.py.

  * level 1: per-part codebook cb1 (p, c1, vl), one k-means per part;
  * level 2: for every (part, l1 cell) a refinement codebook trained on that
    cell's sub-vectors, cb2 (p, c1, c2, vl) -- all p*c1 problems as one
    batched masked k-means;
  * derived: the "virtual" full-dimension L1 centroids (c1, dim) and the
    per-line-part centroid-pair distance table (line_parts, c1, c1);
  * the sparse/dense split: one shared L1 and two sets of refinement
    codebooks, for the densest L1 bins' population and for the rest
    (`train_tree_split`, `mark_dense_vectors`, `mark_dense_vectors_for`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pqt_tpu_torch.config import PQTConfig
from pqt_tpu_torch.models.kmeans import kmeans_batched
from pqt_tpu_torch.ops.distance import (centroid_pair_sqdist,
                                        part_sqdist_tables,
                                        subpart_sqdist_tables)
from pqt_tpu_torch.utils.device import resolve_device


class PQTree(nn.Module):
    """Trained tree; its tensors are the buffers cb1, cb2, centroids_full
    and pair_dists, so `.to(device)` moves it whole."""

    def __init__(self, cb1: torch.Tensor, cb2: torch.Tensor,
                 centroids_full: torch.Tensor, pair_dists: torch.Tensor):
        super().__init__()
        self.register_buffer("cb1", cb1)                  # (p, c1, vl)
        self.register_buffer("cb2", cb2)                  # (p, c1, c2, vl)
        self.register_buffer("centroids_full", centroids_full)   # (c1, dim)
        self.register_buffer("pair_dists", pair_dists)    # (lp, c1, c1)

    @classmethod
    def from_codebooks(cls, cfg: PQTConfig, cb1: torch.Tensor,
                       cb2: torch.Tensor) -> "PQTree":
        p, c1, vl = cb1.shape
        cb1 = cb1.to(torch.float32).contiguous()
        full = cb1.permute(1, 0, 2).reshape(c1, p * vl).contiguous()
        return cls(cb1, cb2.to(torch.float32).contiguous(), full,
                   centroid_pair_sqdist(full, cfg.line_parts))

    @classmethod
    def from_numpy(cls, cfg: PQTConfig, cb1, cb2,
                   device="cuda") -> "PQTree":
        """A tree from codebooks held as numpy arrays (for example the JAX
        package's `np.asarray(tree.cb1)`, `np.asarray(tree.cb2)`)."""
        dev = resolve_device(device)
        return cls.from_codebooks(
            cfg, torch.tensor(np.asarray(cb1, np.float32), device=dev),
            torch.tensor(np.asarray(cb2, np.float32), device=dev))


def _kmeans_kw(cfg: PQTConfig) -> dict:
    return dict(iters=cfg.kmeans_iters, churn_tol=cfg.kmeans_churn_tol,
                move_tol=cfg.kmeans_move_tol,
                split_epsilon=cfg.split_epsilon, init=cfg.kmeans_init)


def _train_level1(cfg: PQTConfig, data: torch.Tensor, gen: torch.Generator):
    """Per-part L1 codebooks (p, c1, vl) and assignments (n, p)."""
    n = data.shape[0]
    parts = data.reshape(n, cfg.p, cfg.vl).permute(1, 0, 2).contiguous()
    masks = torch.ones((cfg.p, 1, n), dtype=torch.bool, device=data.device)
    cb1, assign = kmeans_batched(parts, masks, cfg.c1, generator=gen,
                                 **_kmeans_kw(cfg))
    return cb1[:, 0], assign[:, 0].T


def _train_level2(cfg: PQTConfig, data: torch.Tensor, assign1: torch.Tensor,
                  gen: torch.Generator,
                  population: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Refinement codebooks (p, c1, c2, vl) of every (part, l1 cell),
    fitted on the vectors of `population` ((n,) bool) only when given."""
    n = data.shape[0]
    parts = data.reshape(n, cfg.p, cfg.vl).permute(1, 0, 2).contiguous()
    cells = torch.arange(cfg.c1, device=data.device)
    masks = assign1.T[:, None, :] == cells[None, :, None]     # (p, c1, n)
    if population is not None:
        masks = masks & population[None, None, :]
    cb2, _ = kmeans_batched(parts, masks, cfg.c2, generator=gen,
                            **_kmeans_kw(cfg))
    return cb2


def train_tree(cfg: PQTConfig, train_data, device="cuda") -> PQTree:
    """Train the two-level tree on `train_data` (n, dim), array-like or a
    tensor; uint8 input is cast to float32.  Random draws come from a
    generator on `device` seeded with cfg.seed."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    if not isinstance(train_data, torch.Tensor):
        train_data = torch.as_tensor(np.asarray(train_data))
    data = train_data.to(dev, torch.float32)
    if cfg.train_subsample and data.shape[0] > cfg.train_subsample:
        sel = torch.randperm(data.shape[0], generator=generator,
                             device=dev)[:cfg.train_subsample]
        data = data[sel]
    cb1, assign1 = _train_level1(cfg, data, generator)
    cb2 = _train_level2(cfg, data, assign1, generator)
    return PQTree.from_codebooks(cfg, cb1, cb2)


def mark_dense_vectors(cfg: PQTConfig, assign1: torch.Tensor,
                       percent: float = 0.3) -> torch.Tensor:
    """(n,) bool: True for vectors in the densest full-vector L1 bins that
    together hold `percent` of the population, the crossing bin included.

    A vector's bin is its (n, p) L1 assignment read as a mixed-radix number
    (part 0 most significant).  Bins rank by count, ties by bin id, as the
    JAX package's stable argsort over all c1**p bins ranks them; only the
    occupied bins are counted here (lexicographic rows order as the bin ids
    do), so no table of c1**p slots is made and no bin id can overflow.
    """
    del cfg
    n = assign1.shape[0]
    _, inverse, hist = torch.unique(assign1.to(torch.int64), dim=0,
                                    return_inverse=True, return_counts=True)
    order = torch.sort(-hist, stable=True).indices          # densest first
    cum = torch.cumsum(hist[order], dim=0)
    n_dense = int(torch.sum(cum < percent * n)) + 1
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return (rank < n_dense)[inverse]


def mark_dense_vectors_for(cfg: PQTConfig, tree: "PQTree", data,
                           percent: float = 0.3,
                           chunk: int = 1 << 17) -> torch.Tensor:
    """The dense-population mask (n,) bool of any `data` (array-like or a
    tensor, n rows) under a trained L1: each part assigned to its nearest
    tree.cb1 centroid (first on ties), chunk by chunk on the tree's device,
    then the ranking of `mark_dense_vectors`.  Routes a full dataset into
    the dense and sparse members when the split tree was trained on a
    subsample."""
    dev = tree.cb1.device
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    assign = [torch.argmin(level1_tables(
        cfg, tree, data[s:s + chunk].to(dev, torch.float32)), dim=-1)
        for s in range(0, data.shape[0], chunk)]
    return mark_dense_vectors(cfg, torch.cat(assign), percent)


def train_tree_split(cfg: PQTConfig, train_data, percent: float = 0.3,
                     device="cuda"):
    """Sparse/dense split training: ONE shared L1, then two sets of
    refinement codebooks, one fitted on the dense population (the vectors
    of the busiest L1 bins holding `percent` of the samples) and one on the
    sparse rest.  Three generators on `device`, seeded cfg.seed (L1),
    cfg.seed + 1 (dense) and cfg.seed + 2 (sparse).

    Returns (dense_tree, sparse_tree, dense_mask (n,) bool over the
    training rows)."""
    dev = resolve_device(device)
    gens = [torch.Generator(device=dev).manual_seed(cfg.seed + i)
            for i in range(3)]
    if not isinstance(train_data, torch.Tensor):
        train_data = torch.as_tensor(np.asarray(train_data))
    data = train_data.to(dev, torch.float32)
    cb1, assign1 = _train_level1(cfg, data, gens[0])
    dense = mark_dense_vectors(cfg, assign1, percent)
    cb2_dense = _train_level2(cfg, data, assign1, gens[1], dense)
    cb2_sparse = _train_level2(cfg, data, assign1, gens[2], ~dense)
    return (PQTree.from_codebooks(cfg, cb1, cb2_dense),
            PQTree.from_codebooks(cfg, cb1, cb2_sparse), dense)


def level1_tables(cfg: PQTConfig, tree: PQTree,
                  x: torch.Tensor) -> torch.Tensor:
    """(n, p, c1) squared distances of each part to the L1 codebook."""
    return part_sqdist_tables(x, tree.cb1)


def level2_tables(cfg: PQTConfig, tree: PQTree,
                  x: torch.Tensor) -> torch.Tensor:
    """(n, p, c1, c2) squared distances of each part to every refinement
    codebook (one product over the flattened c1*c2 centroid axis)."""
    flat = tree.cb2.reshape(cfg.p, cfg.c1 * cfg.c2, cfg.vl)
    return part_sqdist_tables(x, flat).reshape(x.shape[0], cfg.p, cfg.c1,
                                               cfg.c2)


def line_tables(cfg: PQTConfig, tree: PQTree,
                x: torch.Tensor) -> torch.Tensor:
    """(n, line_parts, c1) segment distances to the virtual L1 centroids."""
    return subpart_sqdist_tables(x, tree.centroids_full, cfg.line_parts)
