"""k-means (k-means++ or LBG splitting), batched and masked.

Port of pqt_tpu/models/kmeans.py.  The JAX package vmaps one masked k-means
over the (part, cell) problems of a tree level; here the batch is written
out: data is (P, n, d) -- one population per part -- and masks (P, C, n)
select C sub-populations of each, so a whole level is one batched program.
`lax.while_loop` becomes a Python loop that stops once every problem has
converged; a converged problem's state is frozen, as under vmap.

E and M steps are matrix products (distances by the norm identity, M-step
as one-hot^T @ x), chunked over n to bound memory.  Random draws come from
a `torch.Generator`, so training matches the JAX package in quality, not in
bits.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sqdist_to(data, centers):
    """data (P, n, d), centers (P, C, k, d) -> (P, C, n, k) squared dists."""
    xn = torch.sum(data * data, dim=-1)                       # (P, n)
    cn = torch.sum(centers * centers, dim=-1)                 # (P, C, k)
    dot = torch.einsum("pnd,pckd->pcnk", data, centers)
    return torch.clamp_min(xn[:, None, :, None] + cn[:, :, None, :]
                           - 2.0 * dot, 0.0)


def _e_m_step(data, fmask, centroids, prev_assign, chunk):
    """One E+M pass over the data.  Returns (new centroids, assignments
    (P, C, n), churn fraction (P, C) numerator)."""
    P, n, d = data.shape
    C, k = centroids.shape[1:3]
    sums = torch.zeros_like(centroids)
    counts = torch.zeros((P, C, k), dtype=torch.float32, device=data.device)
    churn = torch.zeros((P, C), dtype=torch.float32, device=data.device)
    assign = torch.empty((P, C, n), dtype=torch.int64, device=data.device)
    ks = torch.arange(k, device=data.device)
    for s in range(0, n, chunk):
        x = data[:, s:s + chunk]
        m = fmask[:, :, s:s + chunk]
        a = torch.argmin(_sqdist_to(x, centroids), dim=-1)   # (P, C, m)
        w = (a[..., None] == ks).to(torch.float32) * m[..., None]
        sums += torch.einsum("pcmk,pmd->pckd", w, x)
        counts += torch.sum(w, dim=2)
        churn += torch.sum((a != prev_assign[:, :, s:s + chunk]) * m, dim=-1)
        assign[:, :, s:s + chunk] = a
    new = torch.where(counts[..., None] > 0,
                      sums / torch.clamp_min(counts, 1.0)[..., None],
                      centroids)
    return new, assign, churn


def _lloyd_converge(data, mask, centroids, *, iters, churn_tol, move_tol,
                    chunk):
    """Lloyd iterations until every problem converges or `iters` runs out.

    data (P, n, d); mask (P, C, n) bool; centroids (P, C, k, d).  A problem
    stops when under churn_tol of its population changes assignment, or
    its centroids move less than move_tol relative to their scale.
    Returns (centroids, assignments (P, C, n) int64).
    """
    P, n, _ = data.shape
    C = centroids.shape[1]
    fmask = mask.to(torch.float32)
    n_active = torch.clamp_min(torch.sum(fmask, dim=-1), 1.0)
    assign = torch.full((P, C, n), -1, dtype=torch.int64, device=data.device)
    done = torch.zeros((P, C), dtype=torch.bool, device=data.device)
    for _ in range(iters):
        if bool(done.all()):
            break
        new, new_assign, churn = _e_m_step(data, fmask, centroids, assign,
                                           chunk)
        move = torch.mean(torch.sum((new - centroids) ** 2, dim=-1), dim=-1)
        scale = torch.mean(torch.sum(new ** 2, dim=-1), dim=-1) + 1e-12
        now_done = ((churn / n_active < churn_tol)
                    | (move / scale < move_tol * move_tol))
        active = ~done
        centroids = torch.where(active[..., None, None], new, centroids)
        assign = torch.where(active[..., None], new_assign, assign)
        done = done | now_done
    return centroids, assign


def _cluster_variances(data, mask, centroids, assign, chunk):
    """Per-cluster per-dimension variance (P, C, k, d)."""
    P, n, d = data.shape
    C, k = centroids.shape[1:3]
    fmask = mask.to(torch.float32)
    sx = torch.zeros_like(centroids)
    sxx = torch.zeros_like(centroids)
    counts = torch.zeros((P, C, k), dtype=torch.float32, device=data.device)
    ks = torch.arange(k, device=data.device)
    for s in range(0, n, chunk):
        x = data[:, s:s + chunk]
        w = ((assign[:, :, s:s + chunk, None] == ks).to(torch.float32)
             * fmask[:, :, s:s + chunk, None])
        sx += torch.einsum("pcmk,pmd->pckd", w, x)
        sxx += torch.einsum("pcmk,pmd->pckd", w, x * x)
        counts += torch.sum(w, dim=2)
    c = counts[..., None]
    sq = sxx - 2.0 * centroids * sx + centroids * centroids * c
    return torch.clamp_min(sq, 0.0) / torch.clamp_min(c, 1.0)


def _kmeanspp_init(data, mask, k, gen):
    """k-means++ (D^2 sampling) seeds of every masked population:
    data (P, n, d), mask (P, C, n) -> (P, C, k, d)."""
    P, n, d = data.shape
    C = mask.shape[1]
    fmask = mask.to(torch.float32)
    rows = torch.arange(P, device=data.device)[:, None]

    def pick(dmin):
        # draw an index proportional to the masked dmin; uniform over the
        # mask when all are 0, uniform over all for an empty population
        w = dmin * fmask
        w = torch.where(torch.sum(w, -1, keepdim=True) > 0, w, fmask)
        w = torch.where(torch.sum(w, -1, keepdim=True) > 0, w, 1.0)
        idx = torch.multinomial(w.reshape(P * C, n), 1, generator=gen)
        return data[rows, idx.reshape(P, C)]                  # (P, C, d)

    mean0 = (torch.einsum("pcn,pnd->pcd", fmask, data)
             / torch.clamp_min(torch.sum(fmask, -1), 1.0)[..., None])
    first = pick(_sqdist_to(data, mean0[:, :, None, :])[..., 0])
    centers = [first]
    dmin = _sqdist_to(data, first[:, :, None, :])[..., 0]     # (P, C, n)
    for _ in range(1, k):
        c = pick(dmin)
        centers.append(c)
        dmin = torch.minimum(dmin, _sqdist_to(data, c[:, :, None, :])[..., 0])
    return torch.stack(centers, dim=2)


def kmeans_batched(data: torch.Tensor, masks: torch.Tensor, k: int, *,
                   iters: int = 30, churn_tol: float = 2e-3,
                   move_tol: float = 5e-3, split_epsilon: float = 1e-3,
                   chunk: int = 65536, generator: torch.Generator,
                   init: str = "kmeans++"):
    """k-means of every masked population of every part.

    data (P, n, d); masks (P, C, n) bool.  init: "kmeans++" (D^2 seeding,
    then Lloyd) or "lbg" (the reference's split-doubling ladder, each split
    perturbed along the cluster's own per-dimension spread).
    Returns (centroids (P, C, k, d) float32, assignments (P, C, n) int64,
    valid only where the mask is true).
    """
    data = data.to(torch.float32)
    chunk = max(1, min(chunk, data.shape[1]))
    kw = dict(iters=iters, churn_tol=churn_tol, move_tol=move_tol,
              chunk=chunk)
    if init == "kmeans++":
        centroids = _kmeanspp_init(data, masks, k, generator)
        return _lloyd_converge(data, masks, centroids, **kw)
    if init != "lbg":
        raise ValueError(f"unknown init {init!r}")
    P, n, d = data.shape
    C = masks.shape[1]
    fmask = masks.to(torch.float32)
    denom = torch.clamp_min(torch.sum(fmask, -1), 1.0)[..., None]
    mean0 = torch.einsum("pcn,pnd->pcd", fmask, data) / denom
    ex2 = torch.einsum("pcn,pnd->pcd", fmask, data * data) / denom
    centroids = mean0[:, :, None, :]                          # (P, C, 1, d)
    cvars = torch.clamp_min(ex2 - mean0 * mean0, 0.0)[:, :, None, :]
    cur = 1
    assign = torch.zeros((P, C, n), dtype=torch.int64, device=data.device)
    for _ in range(max(1, (k - 1).bit_length())):
        grow = min(2 * cur, k)
        n_new = grow - cur
        direction = torch.randn((P, C, n_new, d), generator=generator,
                                device=data.device) + 1.0
        eps = split_epsilon * torch.sqrt(cvars[:, :, :n_new] + 1e-12) \
            * direction
        split_from = centroids[:, :, :n_new]
        centroids = torch.cat([split_from - eps, centroids[:, :, n_new:],
                               split_from + eps], dim=2)
        cur = grow
        centroids, assign = _lloyd_converge(data, masks, centroids, **kw)
        if grow < k:
            cvars = _cluster_variances(data, masks, centroids, assign, chunk)
    return centroids, assign


def lbg_kmeans(data: torch.Tensor, mask: Optional[torch.Tensor], k: int, *,
               generator: torch.Generator, **kw):
    """k-means of one (masked) population: data (n, d), mask (n,) or None.
    Returns (centroids (k, d), assignments (n,), valid where mask is true)."""
    if mask is None:
        mask = torch.ones(data.shape[0], dtype=torch.bool, device=data.device)
    c, a = kmeans_batched(data[None], mask[None, None], k,
                          generator=generator, **kw)
    return c[0, 0], a[0, 0]


def batched_masked_kmeans(data: torch.Tensor, masks: torch.Tensor, k: int, *,
                          generator: torch.Generator, **kw) -> torch.Tensor:
    """M independent masked k-means over shared data: data (n, d), masks
    (M, n) -> (M, k, d) centroids."""
    c, _ = kmeans_batched(data[None], masks[None], k, generator=generator,
                          **kw)
    return c[0]
