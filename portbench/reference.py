"""The plain reference: what the port's tree, database and queries should
be, worked out again in plain PyTorch from the run's own inputs.

It imports nothing of the port and nothing of JAX.  It follows the
semantics of the configuration (the JAX package's and the port's
documented algorithm), not their code:

  * encode: per part the code l1 * c2 + l2 of the least level-2 distance
    over the k1_build nearest level-1 cells (first minimum on ties); the
    bin id mixed radix, or each part's code mixed by an odd multiplier,
    summed mod 2^32 and Fibonacci-hashed to log2(hash_size) bits;
  * the inverted file: counts, their exclusive prefix, rows in bin order
    with ids ascending inside a bin; the (part 2j, 2j+1) code-pair
    occupancy;
  * line codes: per (row, line part) the pair A < B of level-1 centroid
    segments of least projection residual, lambda on the payload's grid;
  * the pair pipeline's query: the k1_query nearest level-1 cells a part,
    all c2 refinements, the pair_top_m best pair sums a part pair (with
    the pair filter, pairs absent from the database last), the 2D
    traversal of their ranks in order of sqrt(x) + sqrt(y), the first
    max_bins non-empty bins, at most max_vec_per_bin rows a bin and
    max_candidates in all, ranked by exact squared distance.

  * the tree: k-means++ seeds and Lloyd steps, level 1 a part, level 2 a
    (part, level-1 cell), trained here from its own draws (`train_tree`);
    the program's tree is held to it by their distortions of the training
    rows (`tree_excess`), since k-means++ draws cannot be replayed.

Distances are float64 (exact on integer-valued rows and queries), unless
a caller asks for a lower precision: the control of the correctness check
is this reference in bfloat16.  The bins, line codes and answers are
worked out from the program's codebooks, the program's state after
training; the training itself is checked against the reference's own tree
and the answers against the exact nearest rows (`exact_top`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MIX = (2654435761, 2246822519, 3266489917, 668265263,
       374761393, 3812015801, 2034678193, 1669595009)
FINAL = 2654435761
U32 = 0xFFFFFFFF
INF = float("inf")


def exact_products() -> None:
    """Full float32 products on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def radix(cfg: dict) -> int:
    return cfg["c1"] * cfg["c2"]


def sqdist(x: torch.Tensor, cb: torch.Tensor, dtype) -> torch.Tensor:
    """Squared distances of x (n, p, v) to cb (p, k, v): (n, p, k)."""
    x = x.to(dtype)
    cb = cb.to(dtype)
    dot = torch.einsum("npv,pkv->npk", x, cb)
    d = (x * x).sum(-1)[..., None] + (cb * cb).sum(-1)[None] - 2 * dot
    return d.clamp_min(0)


def mul_u32(acc: torch.Tensor, m: int) -> torch.Tensor:
    """(acc * m) mod 2^32 for acc < 2^32 in int64, no product above 2^48."""
    lo, hi = m & 0xFFFF, m >> 16
    return (acc * lo + (((acc * hi) & 0xFFFF) << 16)) & U32


def _is_exact(cfg: dict) -> bool:
    space = radix(cfg) ** cfg["p"]
    return space <= cfg["hash_size"] and space <= 2 ** 31


def _weights(cfg: dict) -> list:
    r, p = radix(cfg), cfg["p"]
    if _is_exact(cfg):
        return [r ** (p - 1 - j) for j in range(p)]
    return [MIX[j % len(MIX)] for j in range(p)]


def _finalize(cfg: dict, acc: torch.Tensor) -> torch.Tensor:
    if _is_exact(cfg):
        return acc
    shift = 32 - (cfg["hash_size"].bit_length() - 1)
    return mul_u32(acc, FINAL) >> shift


def bin_ids(cfg: dict, codes: torch.Tensor) -> torch.Tensor:
    """Bin id (int64) of per-part codes (..., p)."""
    acc = torch.zeros(codes.shape[:-1], dtype=torch.int64,
                      device=codes.device)
    for j, w in enumerate(_weights(cfg)):
        acc = (acc + codes[..., j] * w) & U32
    return _finalize(cfg, acc)


def _first_k(d: torch.Tensor, k: int):
    """The k smallest along the last axis, ties in index order."""
    v, i = torch.sort(d, dim=-1, stable=True)
    return v[..., :k], i[..., :k]


def encode_codes(cfg: dict, cb1: torch.Tensor, cb2: torch.Tensor,
                 rows: torch.Tensor, dtype=torch.float64,
                 block: int = 1 << 18) -> torch.Tensor:
    """Per-part codes (n, p) int64 of rows (n, dim)."""
    p, c1, c2 = cfg["p"], cfg["c1"], cfg["c2"]
    vl = cfg["dim"] // p
    flat = cb2.reshape(p, c1 * c2, vl)
    out = torch.empty((rows.shape[0], p), dtype=torch.int64,
                      device=rows.device)
    for s in range(0, rows.shape[0], block):
        x = rows[s:s + block].reshape(-1, p, vl)
        d2 = sqdist(x, flat, dtype)                       # (b, p, c1*c2)
        if cfg["k1_build"] < c1:
            _, near = _first_k(sqdist(x, cb1, dtype), cfg["k1_build"])
            keep = torch.zeros(d2.shape[:2] + (c1,), dtype=torch.bool,
                               device=d2.device)
            keep.scatter_(2, near, True)
            d2 = torch.where(keep.repeat_interleave(c2, dim=2), d2, INF)
        out[s:s + block] = torch.argmin(d2, dim=-1)
    return out


class Index(NamedTuple):
    counts: torch.Tensor    # (hash_size,) int64
    starts: torch.Tensor    # (hash_size,) int64 exclusive prefix
    ids: torch.Tensor       # (n,) int64 row ids in bin order
    bins: torch.Tensor      # (n,) int64 bin of each row
    occ: torch.Tensor       # (p // 2, radix^2) bool code-pair occupancy


def build_index(cfg: dict, codes: torch.Tensor) -> Index:
    bins = bin_ids(cfg, codes)
    counts = torch.bincount(bins, minlength=cfg["hash_size"])
    r = radix(cfg)
    occ = torch.zeros((cfg["p"] // 2, r * r), dtype=torch.bool,
                      device=codes.device)
    for j in range(cfg["p"] // 2):
        occ[j, codes[:, 2 * j] * r + codes[:, 2 * j + 1]] = True
    return Index(counts=counts, starts=torch.cumsum(counts, 0) - counts,
                 ids=torch.sort(bins, stable=True).indices, bins=bins,
                 occ=occ)


def pair_sequence(m: int, length: int) -> np.ndarray:
    """Rank pairs of {0..m-1}^2 in order of sqrt(x) + sqrt(y), ties in
    enumeration order (x = i // m, y = i % m): (length, 2)."""
    i = np.arange(m * m, dtype=np.int64)
    x, y = i // m, i % m
    order = np.argsort(np.sqrt(x) + np.sqrt(y), kind="stable")[:length]
    return np.stack([x[order], y[order]], axis=1)


def enum_width(cfg: dict) -> int:
    e = cfg["enum_width"] or cfg["bin_enum_factor"] * cfg["max_bins"]
    return min(e, cfg["pair_top_m"] ** 2, cfg["enum_width_cap"])


def pair_filter_on(cfg: dict) -> bool:
    return (cfg["pair_filter"] and cfg["p"] % 2 == 0
            and radix(cfg) ** 2 <= cfg["pair_filter_max_table"])


def probed_bins(cfg: dict, cb1, cb2, index: Index, q: torch.Tensor,
                dtype=torch.float64) -> torch.Tensor:
    """The enumerated bin ids (S, E) of queries q (S, dim), in order."""
    p, c1, c2, W = cfg["p"], cfg["c1"], cfg["c2"], cfg["k1_query"]
    if cfg["pipeline"] != "pair" or p not in (2, 4):
        raise NotImplementedError("the reference serves the pair pipeline")
    vl = cfg["dim"] // p
    S, L, r = q.shape[0], W * c2, radix(cfg)
    x = q.reshape(S, p, vl)
    _, l1 = _first_k(sqdist(x, cb1, dtype), W)                # (S, p, W)
    d2 = sqdist(x, cb2.reshape(p, c1 * c2, vl), dtype).reshape(S, p, c1, c2)
    cand = torch.gather(d2, 2, l1[..., None].expand(S, p, W, c2))
    cand = cand.reshape(S, p, L)
    codes = (l1[..., None] * c2 + torch.arange(c2, device=q.device)
             ).reshape(S, p, L)
    n_pairs, M = p // 2, min(cfg["pair_top_m"], L * L)
    sums = cand[:, 0::2, :, None] + cand[:, 1::2, None, :]
    d, i = _first_k(sums.reshape(S, n_pairs, L * L), M)
    ca = torch.gather(codes[:, 0::2], 2, i // L)
    cb = torch.gather(codes[:, 1::2], 2, i % L)
    w = _weights(cfg)
    h = torch.stack([(ca[:, j] * w[2 * j] + cb[:, j] * w[2 * j + 1]) & U32
                     for j in range(n_pairs)], dim=1)
    if pair_filter_on(cfg):
        live = torch.stack([index.occ[j][ca[:, j] * r + cb[:, j]]
                            for j in range(n_pairs)], dim=1)
        _, order = _first_k(torch.where(live, d, INF), M)
        h = torch.gather(h, 2, order)
    if n_pairs == 1:
        return _finalize(cfg, h[:, 0, :min(enum_width(cfg), M)])
    seq = torch.as_tensor(pair_sequence(M, min(enum_width(cfg), M * M)),
                          device=q.device)
    return _finalize(cfg, (h[:, 0, seq[:, 0]] + h[:, 1, seq[:, 1]]) & U32)


class Answers(NamedTuple):
    ids: torch.Tensor         # (S, k) int64, -1 = none
    dists: torch.Tensor       # (S, k) float64, +inf = none
    n_candidates: torch.Tensor  # (S,) int64


def candidates(cfg: dict, index: Index, bins: torch.Tensor):
    """Candidate row ids (S, K) and their validity, K = max_candidates:
    the first max_bins non-empty probed bins, at most max_vec_per_bin rows
    of each, in bin order."""
    cnt = index.counts[bins]
    nonempty = cnt > 0
    kept = nonempty & (torch.cumsum(nonempty.to(torch.int64), 1)
                       <= min(cfg["max_bins"], bins.shape[1]))
    capped = torch.where(kept, torch.clamp_max(cnt, cfg["max_vec_per_bin"]),
                         0)
    ends = torch.cumsum(capped, 1)
    K = cfg["max_candidates"]
    slot = torch.arange(K, device=bins.device).expand(bins.shape[0], K)
    owner = torch.clamp_max(torch.searchsorted(ends, slot.contiguous(),
                                               right=True),
                            bins.shape[1] - 1)
    pos = (torch.gather(index.starts[bins], 1, owner) + slot
           - torch.gather(ends - capped, 1, owner))
    valid = slot < ends[:, -1:]
    ids = index.ids[torch.where(valid, pos, 0)]
    return torch.where(valid, ids, -1), valid


def exact_sqdist(rows: torch.Tensor, q: torch.Tensor, dtype=torch.float64):
    """Squared distances of rows (..., dim) to q (dim) broadcast: in float64
    exact for integer-valued inputs."""
    diff = rows.to(dtype) - q.to(dtype)
    return (diff * diff).sum(-1)


def query(cfg: dict, cb1, cb2, index: Index, data: torch.Tensor,
          q: torch.Tensor, k: int, dtype=torch.float64,
          block: int = 128) -> Answers:
    """query_knn(..., k, exact_rerank=True) of queries q (S, dim) over the
    rows `data` (n, dim) (ids = row numbers)."""
    out_i, out_d, out_n = [], [], []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        ids, valid = candidates(cfg, index,
                                probed_bins(cfg, cb1, cb2, index, qb, dtype))
        d = exact_sqdist(data[torch.where(valid, ids, 0)], qb[:, None, :],
                         dtype)
        d = torch.where(valid, d, INF)
        top_d, top_i = _first_k(d, min(k, d.shape[1]))
        top_ids = torch.gather(ids, 1, top_i)
        out_i.append(torch.where(torch.isfinite(top_d), top_ids, -1))
        out_d.append(top_d.to(torch.float64))
        out_n.append(valid.sum(1))
    ids, dists = torch.cat(out_i), torch.cat(out_d)
    if ids.shape[1] < k:
        pad = k - ids.shape[1]
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        dists = torch.nn.functional.pad(dists, (0, pad), value=INF)
    return Answers(ids, dists, torch.cat(out_n))


# --- line codes ------------------------------------------------------------

_LAMBDA_LO, _LAMBDA_SCALE = -4.0, 65536.0 / 8.0


def lambda_u16(lam: torch.Tensor) -> torch.Tensor:
    """lambda on the 16-bit grid of [-4, 4): truncation, the ends clamped."""
    f = (lam - _LAMBDA_LO) * _LAMBDA_SCALE
    f = torch.where(lam >= 4.0, 65535.0, torch.where(lam < -4.0, 0.0, f))
    return torch.nan_to_num(f, nan=0.0).to(torch.int64).clamp(0, 65535)


def line_codes(cfg: dict, cb1: torch.Tensor, rows: torch.Tensor,
               dtype=torch.float64):
    """Per (row, line part) of rows (n, dim): (A, B (n, lp) int64, lambda
    code on the payload's grid (n, lp) int64: 8 bits when compact, else 16;
    t3 (n,) float64 from the decoded lambda)."""
    p, c1, lp, dim = cfg["p"], cfg["c1"], cfg["line_parts"], cfg["dim"]
    full = cb1.permute(1, 0, 2).reshape(c1, dim).to(dtype)
    seg = full.reshape(c1, lp, dim // lp)
    pair = ((seg[:, None] - seg[None]) ** 2).sum(-1).permute(2, 0, 1)
    x = rows.to(dtype).reshape(rows.shape[0], lp, dim // lp)
    part = ((x[:, :, None, :] - seg.permute(1, 0, 2)[None]) ** 2).sum(-1)
    a2 = part[:, :, None, :]            # distance to B
    b2 = part[:, :, :, None]            # distance to A
    c2 = pair[None].clamp_min(1e-20)
    lam = -0.5 * (a2 - b2 - pair[None]) / c2
    resid = b2 - lam * lam * c2
    upper = torch.ones((c1, c1), dtype=torch.bool, device=rows.device)
    resid = torch.where(upper.triu(1), resid, INF)
    best = torch.argmin(resid.reshape(rows.shape[0], lp, c1 * c1), dim=-1)
    lam_b = torch.gather(lam.reshape(rows.shape[0], lp, -1), 2,
                         best[..., None])[..., 0]
    c2_b = torch.gather(pair.reshape(1, lp, -1).expand(rows.shape[0], lp, -1),
                        2, best[..., None])[..., 0]
    u16 = lambda_u16(lam_b)
    compact = cfg["payload_compact"] and c1 <= 16
    u8 = torch.clamp_max((u16 + 128) >> 8, 255)
    if compact:
        code, grid = u8, u8 << 8
    else:
        code = grid = u8 << 8 if cfg["lambda_bits"] == 8 else u16
    lam_q = grid.to(dtype) / _LAMBDA_SCALE + _LAMBDA_LO
    t3 = ((lam_q * lam_q - lam_q) * c2_b).sum(-1)
    return best // c1, best % c1, code, t3


def unpack_payload(cfg: dict, rows: torch.Tensor):
    """The port's payload rows (n, W) int32 -> (ids, A, B, lambda code on
    the payload's grid (n, lp) int64, t3 (n,) float64): column 0 the id,
    column 1 t3's float32 bits, then per line part A | B << 8 | u16 << 16
    (wide) or, compact, two parts a column, A | B << 4 | u8 << 8, low half
    first."""
    lp = cfg["line_parts"]
    words = rows[:, 2:].to(torch.int64) & U32
    t3 = rows[:, 1].contiguous().view(torch.float32).to(torch.float64)
    if cfg["payload_compact"] and cfg["c1"] <= 16:
        half = torch.stack([words & 0xFFFF, words >> 16], -1).reshape(
            rows.shape[0], -1)[:, :lp]
        return (rows[:, 0].to(torch.int64), half & 0xF, (half >> 4) & 0xF,
                (half >> 8) & 0xFF, t3)
    return (rows[:, 0].to(torch.int64), words & 0xFF, (words >> 8) & 0xFF,
            words >> 16, t3)


# --- the tree, trained again -----------------------------------------------

def _kmeanspp(x: torch.Tensor, groups: torch.Tensor, n_groups: int, k: int,
              gen: torch.Generator) -> torch.Tensor:
    """k-means++ seeds (n_groups, k, v) of the rows x (n, v), row i in group
    groups[i]: the first uniform, each next drawn with probability
    proportional to the squared distance to the nearest seed so far (a
    uniform draw where every row of a group sits on a seed; a group with
    no rows gets zeros)."""
    n, v = x.shape
    order = torch.argsort(groups, stable=True)
    xs, gs = x[order], groups[order]
    size = torch.bincount(gs, minlength=n_groups)
    start = torch.cumsum(size, 0) - size
    seeds = torch.zeros((n_groups, k, v), dtype=x.dtype, device=x.device)
    has = size > 0
    best = torch.full((n,), INF, dtype=x.dtype, device=x.device)
    for j in range(k):
        u = torch.rand(n_groups, generator=gen, device=x.device,
                       dtype=torch.float64)
        if j == 0:
            pick = start + torch.clamp_max((u * size).long(), size - 1)
        else:
            w = best.to(torch.float64)
            cw = torch.cumsum(w, 0)
            before = torch.where(start > 0, cw[(start - 1).clamp_min(0)],
                                 0.0)
            total = cw[(start + size - 1).clamp_min(0)] - before
            target = before + u * total
            pick = torch.searchsorted(cw, target, right=True)
            pick = torch.minimum(torch.maximum(pick, start),
                                 start + size - 1)
            flat = total <= 0
            pick = torch.where(flat, start + torch.clamp_max(
                (u * size).long(), size - 1), pick)
        pick = torch.where(has, pick, 0).clamp(0, n - 1)
        seeds[:, j] = torch.where(has[:, None], xs[pick], 0.0)
        best = torch.minimum(best, ((xs - seeds[gs, j]) ** 2).sum(-1))
    return seeds


def _assign(x: torch.Tensor, cb: torch.Tensor, groups: torch.Tensor,
            block: int = 1 << 16):
    """(nearest centroid, its squared distance) of each row x (n, v) among
    its group's centroids cb (n_groups, k, v); first minimum on ties."""
    a, d = [], []
    for s in range(0, x.shape[0], block):
        xb, gb = x[s:s + block], groups[s:s + block]
        dist = ((xb[:, None, :] - cb[gb]) ** 2).sum(-1)
        m, i = dist.min(-1)
        a.append(i)
        d.append(m)
    return torch.cat(a), torch.cat(d)


def _kmeans(x: torch.Tensor, groups: torch.Tensor, n_groups: int, k: int,
            cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """Lloyd's k-means of every group at once from k-means++ seeds: up to
    kmeans_iters steps, ending early once fewer than kmeans_churn_tol of
    the rows change cell; an empty cell keeps its centroid."""
    if cfg["kmeans_init"] != "kmeans++":
        raise NotImplementedError("the reference seeds by k-means++")
    cb = _kmeanspp(x, groups, n_groups, k, gen)
    prev = None
    for _ in range(cfg["kmeans_iters"]):
        a, _ = _assign(x, cb, groups)
        if prev is not None and float((a != prev).double().mean()) < \
                cfg["kmeans_churn_tol"]:
            break
        prev = a
        cell = groups * k + a
        sums = torch.zeros((n_groups * k, x.shape[1]), dtype=x.dtype,
                           device=x.device).index_add_(0, cell, x)
        cnt = torch.bincount(cell, minlength=n_groups * k)[:, None]
        cb = torch.where(cnt > 0, sums / cnt.clamp_min(1).to(x.dtype),
                         cb.reshape(n_groups * k, -1)).reshape(cb.shape)
    return cb


def train_tree(cfg: dict, train: torch.Tensor, seed: int,
               dtype=torch.float64):
    """The two-level tree of the rows `train` (n, dim), trained here from
    its own draws: (cb1 (p, c1, vl), cb2 (p, c1, c2, vl)).  Level 1 is a
    k-means of each part's sub-vectors, level 2 one of every (part, level-1
    cell)'s sub-vectors; at most train_subsample rows (a draw of them) when
    that is set."""
    p, c1, c2 = cfg["p"], cfg["c1"], cfg["c2"]
    vl = cfg["dim"] // p
    gen = torch.Generator(device=train.device).manual_seed(
        seed % (1 << 63))
    x = train.to(dtype)
    sub = cfg.get("train_subsample", 0)
    if sub and x.shape[0] > sub:
        x = x[torch.randperm(x.shape[0], generator=gen,
                             device=x.device)[:sub]]
    x = x.reshape(-1, p, vl)
    zero = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    cb1 = torch.stack([_kmeans(x[:, j], zero, 1, c1, cfg, gen)[0]
                       for j in range(p)])
    cb2 = torch.stack([
        _kmeans(x[:, j], _assign(x[:, j], cb1[j:j + 1], zero)[0], c1, c2,
                cfg, gen) for j in range(p)])
    return cb1, cb2


def tree_distortion(cfg: dict, cb1: torch.Tensor, cb2: torch.Tensor,
                    rows: torch.Tensor):
    """(level-1, level-2) quantisation distortion of rows (n, dim) in
    float64: each part's squared distance to its nearest level-1 centroid,
    and to the nearest level-2 centroid of that cell, summed."""
    p = cfg["p"]
    x = rows.to(torch.float64).reshape(rows.shape[0], p, -1)
    zero = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    d1 = d2 = 0.0
    for j in range(p):
        a1, e1 = _assign(x[:, j], cb1[j:j + 1].to(torch.float64), zero)
        _, e2 = _assign(x[:, j], cb2[j].to(torch.float64), a1)
        d1 += float(e1.sum())
        d2 += float(e2.sum())
    return d1, d2


def tree_excess(cfg: dict, cb1, cb2, ref_cb1, ref_cb2,
                rows: torch.Tensor) -> float:
    """How much more the tree (cb1, cb2) distorts the rows than the
    reference's own tree: the larger of the two levels' ratios, less 1."""
    got = tree_distortion(cfg, cb1, cb2, rows)
    want = tree_distortion(cfg, ref_cb1, ref_cb2, rows)
    return max(g / w for g, w in zip(got, want)) - 1.0


# --- ground truth -----------------------------------------------------------

def exact_top(data: torch.Tensor, q: torch.Tensor, k: int,
              q_block: int = 4096, row_block: int = 1 << 18) -> torch.Tensor:
    """The k nearest row ids (S, k) of integer-valued queries q (S, dim) by
    exact squared distance less the query's own norm, |x|^2 - 2 q.x
    (float32 products and sums of integers below 2^24 are exact with TF32
    off); among tied distances any may be taken.  Each block of rows is
    cast once and met by every block of queries."""
    exact_products()
    S = q.shape[0]
    best_d = torch.full((S, 0), INF, device=q.device)
    best_i = torch.empty((S, 0), dtype=torch.int64, device=q.device)
    qf = q.to(torch.float32)
    for r in range(0, data.shape[0], row_block):
        x = data[r:r + row_block].to(torch.float32)
        xn = (x * x).sum(-1)[None]
        vs, js = [], []
        for s in range(0, S, q_block):
            d = torch.addmm(xn, qf[s:s + q_block], x.T, alpha=-2.0)
            v, i = torch.topk(d, min(k, d.shape[1]), dim=1, largest=False)
            vs.append(v)
            js.append(i + r)
        cd = torch.cat([best_d, torch.cat(vs)], 1)
        ci = torch.cat([best_i, torch.cat(js)], 1)
        v, i = torch.topk(cd, min(k, cd.shape[1]), dim=1, largest=False)
        best_d, best_i = v, torch.gather(ci, 1, i)
    return best_i
