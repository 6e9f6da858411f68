"""k-means (k-means++ or LBG splitting), batched and masked.

Port of pqt_tpu/models/kmeans.py.  The JAX package vmaps one masked k-means
over the (part, cell) problems of a tree level; here the batch is written
out: data is (P, n, d) -- one population per part -- and masks (P, C, n)
select C sub-populations of each, so a whole level is one batched program.
`lax.while_loop` becomes a loop that stops once every problem has
converged; a converged problem's state is frozen, as under vmap.

On a card the loops run as CUDA graphs (utils/graphs.py, the loop form):
one Lloyd step with the freeze (`_lloyd_step`) captured once a key (the
shapes -- so one a centroid count of the LBG ladder -- and the
tolerances), replayed LLOYD_BLOCK times between two reads of `done`, the
one host synchronisation a block where the eager loop makes one a step.
A finished problem is frozen, so the steps a block runs past the last
problem's convergence change nothing: the result equals the eager loop's
to the bit.  The k-means++ picks after the first are one graph a shape
(`_pick_step`: draw, write the centre at a device index, update the
distances) replayed k - 1 times, the generator registered with the
capture; its draws are the eager `torch.multinomial` draws.  CUDA's
conditional WHILE node would remove the read a block too, but this torch
exposes no capture into a conditional body.

E and M steps are matrix products (distances by the norm identity, M-step
as one-hot^T @ x), chunked over n to bound memory.  Random draws come from
a `torch.Generator`, so training matches the JAX package in quality, not in
bits.
"""

from __future__ import annotations

import functools
import threading
from typing import Optional

import torch

from pqt_tpu_torch.utils import graphs

# Lloyd steps replayed between two reads of `done` on the card: at the
# 30-iteration SIFT1M train (chip_smoke.py's block sweep, PERF.md) blocks
# of 1, 2 and 4 took the same time within 2.3% and 2 was the fastest in
# both runs, 8 ran 4 steps more and 9% longer.
LLOYD_BLOCK = 2
# {"run": Lloyd steps run, "replayed": those of them replayed from a
# graph}, summed over calls (the eager loop stops at the step after which
# every problem has converged; a replayed loop may run up to LLOYD_BLOCK - 1
# frozen steps past it).
lloyd_steps = {"run": 0, "replayed": 0}
_LOCK = threading.Lock()


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


def _lloyd_step(centroids, assign, done, data, fmask, n_active, *,
                churn_tol, move_tol, chunk):
    """One Lloyd iteration of every problem not yet done, the others
    frozen: the new (centroids, assign, done)."""
    new, new_assign, churn = _e_m_step(data, fmask, centroids, assign, chunk)
    move = torch.mean(torch.sum((new - centroids) ** 2, dim=-1), dim=-1)
    scale = torch.mean(torch.sum(new ** 2, dim=-1), dim=-1) + 1e-12
    now_done = ((churn / n_active < churn_tol)
                | (move / scale < move_tol * move_tol))
    active = ~done
    centroids = torch.where(active[..., None, None], new, centroids)
    assign = torch.where(active[..., None], new_assign, assign)
    return centroids, assign, done | now_done


def _lloyd_converge(data, mask, centroids, *, iters, churn_tol, move_tol,
                    chunk):
    """Lloyd iterations until every problem converges or `iters` runs out.

    data (P, n, d); mask (P, C, n) bool; centroids (P, C, k, d).  A problem
    stops when under churn_tol of its population changes assignment, or
    its centroids move less than move_tol relative to their scale.
    Returns (centroids, assignments (P, C, n) int64).  On a card the steps
    are replays of one graph a key, `done` read once a LLOYD_BLOCK of them
    (the module docstring); `_lloyd_converge.graphs` holds the entries.
    """
    P, n, _ = data.shape
    C = centroids.shape[1]
    fmask = mask.to(torch.float32)
    n_active = torch.clamp_min(torch.sum(fmask, dim=-1), 1.0)
    assign = torch.full((P, C, n), -1, dtype=torch.int64, device=data.device)
    done = torch.zeros((P, C), dtype=torch.bool, device=data.device)
    step = functools.partial(_lloyd_step, churn_tol=churn_tol,
                             move_tol=move_tol, chunk=chunk)
    consts = (data, fmask, n_active)
    if not graphs._served(data):
        for _ in range(iters):
            if bool(done.all()):
                break
            centroids, assign, done = step(centroids, assign, done, *consts)
            lloyd_steps["run"] += 1
        return centroids, assign
    key = ("lloyd", tuple(data.shape), tuple(centroids.shape), data.device,
           churn_tol, move_tol, chunk)
    with _LOCK:
        made = 0
        if iters > 0 and done.numel():
            entry, made = graphs.loop_or_capture(
                _lloyd_converge.graphs, key, step,
                (centroids, assign, done) + consts, 3, data.device)
            while made < iters and not bool(entry.state[2].all()):
                steps = min(LLOYD_BLOCK, iters - made)
                entry.replay(steps)
                made += steps
                lloyd_steps["replayed"] += steps
            centroids, assign = (x.clone() for x in entry.state[:2])
        lloyd_steps["run"] += made
    return centroids, assign


_lloyd_converge.graphs = {}


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


def _pick(data, fmask, dmin, gen):
    """One k-means++ draw a problem, an index proportional to the masked
    dmin (uniform over the mask when all are 0, uniform over all for an
    empty population): its row (P, C, d)."""
    P, n, _ = data.shape
    C = fmask.shape[1]
    w = dmin * fmask
    w = torch.where(torch.sum(w, -1, keepdim=True) > 0, w, fmask)
    w = torch.where(torch.sum(w, -1, keepdim=True) > 0, w, 1.0)
    idx = torch.multinomial(w.reshape(P * C, n), 1, generator=gen)
    rows = torch.arange(P, device=data.device)[:, None]
    return data[rows, idx.reshape(P, C)]


def _pick_step(centers, dmin, at, data, fmask, *, gen):
    """Pick the next centre, write it at index `at` (a 0-d int64 tensor)
    of centers (P, C, k, d) and update dmin: the new (centers, dmin,
    at + 1)."""
    c = _pick(data, fmask, dmin, gen)
    centers = centers.index_copy(2, at.view(1), c[:, :, None, :])
    dmin = torch.minimum(dmin, _sqdist_to(data, c[:, :, None, :])[..., 0])
    return centers, dmin, at + 1


def _kmeanspp_init(data, mask, k, gen):
    """k-means++ (D^2 sampling) seeds of every masked population:
    data (P, n, d), mask (P, C, n) -> (P, C, k, d).  On a card the k - 1
    picks after the first replay one graph a shape
    (`_kmeanspp_init.graphs`), drawing from a generator of the graphs'
    own that takes `gen`'s state before the replays and gives it back
    after, so `gen` moves on as the eager picks move it."""
    P, n, d = data.shape
    C = mask.shape[1]
    fmask = mask.to(torch.float32)
    mean0 = (torch.einsum("pcn,pnd->pcd", fmask, data)
             / torch.clamp_min(torch.sum(fmask, -1), 1.0)[..., None])
    first = _pick(data, fmask, _sqdist_to(data, mean0[:, :, None, :])[..., 0],
                  gen)
    dmin = _sqdist_to(data, first[:, :, None, :])[..., 0]     # (P, C, n)
    centers = torch.zeros((P, C, k, d), dtype=data.dtype, device=data.device)
    centers[:, :, 0] = first
    at = torch.ones((), dtype=torch.int64, device=data.device)
    if k == 1:
        return centers
    if not graphs._served(data):
        for _ in range(1, k):
            centers, dmin, at = _pick_step(centers, dmin, at, data, fmask,
                                           gen=gen)
        return centers
    own = _graph_generator(data.device)
    key = ("pick", tuple(data.shape), tuple(centers.shape), data.device)
    with _LOCK:
        own.set_state(gen.get_state())
        entry, made = graphs.loop_or_capture(
            _kmeanspp_init.graphs, key,
            functools.partial(_pick_step, gen=own),
            (centers, dmin, at, data, fmask), 3, data.device, (own,))
        entry.replay(k - 1 - made)
        gen.set_state(own.get_state())
        return entry.state[0].clone()


_kmeanspp_init.graphs = {}


@functools.cache
def _graph_generator(device: torch.device) -> torch.Generator:
    """The generator the pick graphs on `device` are captured with."""
    return torch.Generator(device=device)


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
