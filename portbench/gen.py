"""The inputs of a run, made from its seed on the device.

The SIFT-like cluster model of the repository's fixtures (chip_smoke.py
`make_sift_like` / `make_queries`, with benchmarks/rehearsal_50m.py's
scaling of the coarse clusters with n), rewritten in PyTorch on the device:
coarse centres uniform in [0, center_high), subclusters around them with
sigma_coarse, points around a uniformly drawn subcluster with sigma_point,
rounded and clipped to uint8.  Queries are fresh draws from the same model
(held out: no query is a database row), integer-valued float32 as SIFT's
queries are.  The sizes come from the configuration and the traffic only,
so every seed does the same amount of work.

What a traffic mix may set here:

  * `pool`: the number of queries (0: none);
  * `query_dist`: how a query's subcluster is drawn, {"kind": "uniform"}
    (the default, as the rows') or {"kind": "zipf", "s": 1.1}, the
    subclusters ranked in an order drawn from the seed and the one of
    rank r drawn with probability proportional to (r + 1)^-s;
  * `rotate_rows`: R rows after the n rows of the database that repeat
    its first R, so that `rows(o)` for 0 <= o <= R is the database rotated
    by o rows without a copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BLOCK = 1 << 20


class Inputs(NamedTuple):
    data: np.ndarray        # (n, dim) uint8, on the host
    queries: np.ndarray     # (pool, dim) float32, integer-valued, on the host
    ring: np.ndarray        # (n + rotate_rows, dim): data, then its head

    def rows(self, offset: int) -> np.ndarray:
        """The database rotated by `offset` rows: a view of `ring`."""
        if not 0 <= offset <= self.ring.shape[0] - self.data.shape[0]:
            raise ValueError(f"rotation {offset} past rotate_rows")
        return self.ring[offset:offset + self.data.shape[0]]


def _subclusters(model: dict, gen: torch.Generator, device) -> torch.Tensor:
    dim, n_coarse = model["dim"], model["n_coarse"]
    centers = torch.rand((n_coarse, dim), generator=gen, device=device)
    centers = centers * model["center_high"]
    subs = centers.repeat_interleave(model["subs_per_coarse"], dim=0)
    return subs + model["sigma_coarse"] * torch.randn(
        subs.shape, generator=gen, device=device)


def _draw(sub: torch.Tensor, n: int, sigma: float, gen: torch.Generator,
          which: torch.Tensor | None = None) -> torch.Tensor:
    if which is None:
        which = torch.randint(0, sub.shape[0], (n,), generator=gen,
                              device=sub.device)
    x = sub[which] + sigma * torch.randn((n, sub.shape[1]), generator=gen,
                                         device=sub.device)
    return torch.clamp(torch.round(x), 0, 255)


def _query_subclusters(dist: dict, n_sub: int, pool: int,
                       gen: torch.Generator, device):
    """The subcluster of each query (None: uniform, drawn in _draw)."""
    kind = dist.get("kind", "uniform")
    if kind == "uniform":
        return None
    if kind == "zipf":
        rank = torch.randperm(n_sub, generator=gen, device=device)
        w = (rank.to(torch.float64) + 1.0) ** -float(dist["s"])
        return torch.multinomial(w, pool, replacement=True, generator=gen)
    raise ValueError(f"unknown query_dist kind {kind!r}")


def make_inputs(model: dict, traffic: dict, seed: int, device) -> Inputs:
    """The database rows and the query pool of one run."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sub = _subclusters(model, gen, device)
    n, dim = model["n"], model["dim"]
    extra = int(traffic.get("rotate_rows", 0))
    if extra > n:
        raise ValueError("rotate_rows above the database's rows")
    ring = np.empty((n + extra, dim), np.uint8)
    host = torch.from_numpy(ring)
    cuda = torch.device(device).type == "cuda"
    stage = torch.empty((min(n, BLOCK), dim), dtype=torch.uint8,
                        pin_memory=cuda)
    for s in range(0, n, BLOCK):
        e = min(n, s + BLOCK)
        block = _draw(sub, e - s, model["sigma_point"], gen).to(torch.uint8)
        stage[:e - s].copy_(block)
        host[s:e].copy_(stage[:e - s])
    ring[n:] = ring[:extra]
    pool = int(traffic.get("pool", 0))
    which = _query_subclusters(traffic.get("query_dist", {}), sub.shape[0],
                               pool, gen, device)
    queries = _draw(sub, pool, model["sigma_point"], gen, which).to(
        torch.float32).cpu().numpy()
    return Inputs(ring[:n], queries, ring)
