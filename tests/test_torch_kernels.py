"""The port's kernel wrappers (plain versions on the CPU) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_pallas_*.py
run them.

On a CPU tensor each wrapper runs its plain PyTorch version; the CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import pqt_tpu.utils.cache
from pqt_tpu.config import PQTConfig
from pqt_tpu.models.db import (pack_payload, pack_payload_compact,
                               unpack_payload_cfg)
from pqt_tpu.ops.linecodes import reconstruct_dists_idx
from pqt_tpu.ops.pallas import primitives as PP
from pqt_tpu.ops.pallas.rerank import BLOCK, rerank_fused as pallas_rerank
from pqt_tpu_torch.ops.cuda import primitives as prim
from pqt_tpu_torch.ops.cuda.gather import gather_rows, lut_gather
from pqt_tpu_torch.ops.cuda.primitives import (bitonic_topk,
                                               bitonic_topk_plain, block_scan,
                                               segmented_reduce)
from pqt_tpu_torch.ops.cuda.rerank import rerank_fused

BENCHMARKS = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"


@pytest.mark.parametrize("n,k", [(16, 8), (1024, 100), (16384, 128)])
def test_topk_matches_pallas_bitonic(n, k):
    rng = np.random.default_rng(n + k)
    x = rng.normal(0, 1, (8, n)).astype(np.float32)
    want_v, want_i = PP.bitonic_topk(jnp.asarray(x), k, interpret=True)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # distinct values: the index of each value is unique
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("n,k", [(512, 16), (1024, 100)])
def test_topk_ties_follow_lax_top_k(n, k):
    """With duplicates (test_pallas_primitives.py's generator) the values
    equal the Pallas kernel's and the indices equal lax.top_k's: ties come
    out lowest index first, which the Pallas network does not promise."""
    rng = np.random.default_rng(3 * n + k)
    x = rng.integers(0, 8, (8, n)).astype(np.float32)
    x[:, ::7] = np.inf
    want_v, _ = PP.bitonic_topk(jnp.asarray(x), k, interpret=True)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), k)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(lax_i))


def test_topk_non_power_of_two_row():
    rng = np.random.default_rng(800)
    x = rng.integers(0, 50, (16, 800)).astype(np.float32)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), 100)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), 100)
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(lax_i))


# (rows, n, k) of every top-k call on the query paths at batch 256, and at
# SIFT1B_CONFIG's widths, with the mode kernel A takes there.
TOPK_SHAPES = {
    "l1_select": ((1024, 16, 8), "sort"),
    "pair_select": ((512, 16384, 128), "select"),
    "pair_filter_resort": ((512, 128, 128), "sort"),
    "part_sort": ((1024, 128, 128), "sort"),
    "final_topk": ((256, 1024, 100), "select"),
    "refine_line_topk": ((256, 1024, 800), "sort"),
    "refine_exact_topk": ((256, 800, 100), "select"),
    "sift1b_pair_select": ((512, 65536, 256), "select"),
    "sift1b_final_topk": ((256, 8192, 100), "select"),
    "sift1b_refine_line_topk": ((256, 8192, 800), "select"),
    "sift1b_big_pair_merge": ((128, 65536, 256), "select"),
    "sift1b_big_final_bins": ((64, 65536, 32768), "merge"),
    "big_final_bins_all": ((64, 65536, 65536), "merge"),
}


@pytest.mark.parametrize("name", sorted(TOPK_SHAPES))
def test_topk_plan_picks_the_mode(name):
    (_, n, k), mode = TOPK_SHAPES[name]
    plan = prim._topk_plan(n, k)
    assert plan.mode == mode
    if plan.cluster:
        # the cluster route: each block holds a slice of the row in
        # registers, and block 0 sorts the select's candidates, or each
        # block its share of the merge's pairs, in shared memory
        T = plan.threads
        assert n > prim.TOPK_SORT_MAX and plan.cluster <= 8
        assert -(-n // plan.cluster) <= plan.items * T
        assert plan.sort_len & (plan.sort_len - 1) == 0 or mode == "merge"
        if mode == "merge":
            assert plan.sort_len % T == 0
            assert plan.cluster * plan.sort_len >= k
            assert plan.sort_len <= prim.TOPK_CLUSTER_RUN
        else:
            assert min(n, plan.cluster * k) <= plan.sort_len
            assert plan.sort_len <= prim.TOPK_SORT_MAX
        # the one-block route stays for what the cluster does not take
        plan = prim._topk_plan(n, k, cluster=0)
        assert plan.mode == mode and not plan.cluster
    assert plan.sort_len >= (n if mode == "sort" else k)
    assert plan.sort_len & (plan.sort_len - 1) == 0
    if mode == "merge":
        # whole runs of one block's sort, whole merge tiles
        assert prim.TOPK_SORT_MAX <= plan.sort_len <= prim.TOPK_MERGE_MAX
        assert plan.sort_len % prim.TOPK_MERGE_TILE == 0
        assert plan.threads % 32 == 0 and plan.items == 32
        return
    assert plan.sort_len <= prim.TOPK_SORT_MAX
    if mode == "select":
        # whole warps, and a row of up to 16384 held in one tile
        assert plan.threads % 32 == 0
        assert plan.threads <= prim.TOPK_SELECT_THREADS
        assert (plan.items * plan.threads >= n) == (n <= 16384)


def test_topk_plan_limits():
    """Rows above 16384 elements take select mode, and k above 16384 merge
    mode up to its cap; what no mode takes raises."""
    for n in (16385, 65536, 70001, prim.TOPK_SELECT_MAX_ROW):
        assert prim._topk_plan(n, 256).mode == "select"
        with pytest.raises(NotImplementedError):
            prim._topk_plan(n, 256, "sort")
    assert prim._topk_plan(70001, 16385).mode == "merge"
    with pytest.raises(NotImplementedError):
        prim._topk_plan(70001, 16385, "select")
    with pytest.raises(NotImplementedError):
        prim._topk_plan(prim.TOPK_MERGE_MAX + 1, prim.TOPK_MERGE_MAX + 1)
    with pytest.raises(NotImplementedError):
        prim._topk_plan(prim.TOPK_SELECT_MAX_ROW + 1, 1)
    with pytest.raises(ValueError):
        prim._topk_plan(16, 17)
    x = torch.zeros((2, 70001))
    with pytest.raises(NotImplementedError):
        bitonic_topk(torch.zeros((1, prim.TOPK_MERGE_MAX + 1)),
                     prim.TOPK_MERGE_MAX + 1)
    assert bitonic_topk(x, 3)[1].tolist() == [[0, 1, 2]] * 2


def _float_keys(x):
    """csrc/topk.cu's order-preserving key: a negative float flips every
    bit, a non-negative one its sign bit; -0.0 takes +0.0's key."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _select_model(x, k, seed=0):
    """Select mode as csrc/topk.cu runs it, row by row: the k-th smallest
    key by 8-bit digits from the top (stopping once its bucket is taken
    whole), every key below the cut in any order, the first ties in
    position order, then a sort of the k pairs by (value, position)."""
    rng = np.random.default_rng(seed)
    bits, bins = prim.TOPK_DIGIT_BITS, 1 << prim.TOPK_DIGIT_BITS
    out_v, out_i = [], []
    for row in x:
        key = _float_keys(row).astype(np.int64)
        prefix, shift, need = 0, 32, k
        while shift > 0:
            lo = shift - bits
            live = (key >> shift) == (prefix >> shift)
            hist = np.bincount((key[live] >> lo) & (bins - 1),
                               minlength=bins)
            incl = np.cumsum(hist)
            bucket = int(np.searchsorted(incl, need))  # first incl >= need
            before = int(incl[bucket] - hist[bucket])
            prefix |= bucket << lo
            need -= before
            shift = lo
            if need == hist[bucket]:
                break
        cut = prefix >> shift
        below = np.flatnonzero((key >> shift) < cut)
        ties = np.flatnonzero((key >> shift) == cut)[:need]
        assert below.size == k - need and ties.size == need
        taken = np.concatenate([rng.permutation(below), ties])
        order = np.lexsort((taken, row[taken]))      # value, then position
        out_v.append(row[taken[order]])
        out_i.append(taken[order].astype(np.int32))
    return np.stack(out_v), np.stack(out_i)


def _tie_heavy(rng, b, n):
    """Values from a handful of levels, some of them negative, with +inf
    mixed in."""
    levels = np.array([-2.5, 0.5, 1.0, 3.0, 1e4], np.float32)
    x = levels[rng.integers(0, levels.size, (b, n))]
    x[rng.random((b, n)) < 0.1] = np.inf
    return x


@pytest.mark.parametrize("b,n,k", [(4, 1024, 100), (4, 800, 100),
                                   (2, 16384, 128), (2, 8192, 800),
                                   (2, 65536, 256), (3, 4096, 1),
                                   (3, 300, 300), (2, 4096, 3000)])
def test_select_model_matches_lax_top_k(b, n, k):
    """The model of select mode equals lax.top_k of the negated row and the
    plain version, values and positions, on tie-heavy rows: the cut falls
    among many copies of the k-th value."""
    rng = np.random.default_rng(b * n + k)
    x = _tie_heavy(rng, b, n)
    got_v, got_i = _select_model(x, k, seed=k)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), k)
    np.testing.assert_array_equal(got_v, -np.asarray(neg))
    np.testing.assert_array_equal(got_i, np.asarray(lax_i))
    plain_v, plain_i = bitonic_topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v, plain_v.numpy())
    np.testing.assert_array_equal(got_i, plain_i.numpy())


def _pair_keys(v, i):
    """(value, index) pairs as one sortable uint64: the value's
    order-preserving key above the index (the padding's INT_MAX last)."""
    return (_float_keys(v).astype(np.uint64) << np.uint64(32)) | \
        i.astype(np.uint64)


def _merge_path(a, b, diag):
    """csrc/topk.cu's merge_path over uint64 pair keys: how many of the
    first `diag` outputs of the stable merge come from a."""
    lo, hi = max(0, diag - len(b)), min(diag, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if b[diag - 1 - mid] < a[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


def _merge_model(x, k, seed=0):
    """Merge mode on the one-block route as csrc/topk.cu runs it, row by
    row: the select's k
    survivors in any order (the whole row for k = n) in a scratch row of
    len pairs, runs of TOPK_SORT_MAX sorted by (value, index), then merge
    passes in which every 4096-pair tile finds its split points by
    merge_path and each of its 512 threads merges 8 outputs from a split of
    its own."""
    rng = np.random.default_rng(seed)
    n = x.shape[1]
    plan = prim._topk_plan(n, k, cluster=0)
    assert plan.mode == "merge"
    L, R, tile, items = (plan.sort_len, prim.TOPK_SORT_MAX,
                         prim.TOPK_MERGE_TILE, 8)
    out_v, out_i = [], []
    for row in x:
        if k < n:
            _, taken = _select_model(row[None], k, seed)
            taken = rng.permutation(taken[0])      # the select's any order
        else:
            taken = np.arange(n)
        keys = np.full(L, _pair_keys(np.array([np.inf], np.float32),
                                     np.array([2 ** 31 - 1]))[0], np.uint64)
        keys[:k] = _pair_keys(row[taken], taken)
        keys = np.concatenate([np.sort(keys[r:r + R])
                               for r in range(0, L, R)])
        width = R
        while width < L:
            nxt = np.empty_like(keys)
            for o0 in range(0, L, tile):
                p0 = o0 // (2 * width) * (2 * width)
                a, b = keys[p0:p0 + width], keys[p0 + width:p0 + 2 * width]
                d0 = o0 - p0
                a0, a1 = _merge_path(a, b, d0), _merge_path(a, b, d0 + tile)
                ta, tb = a[a0:a1], b[d0 - a0:d0 + tile - a1]
                for t in range(0, tile, items):
                    ia = _merge_path(ta, tb, t)
                    ib = t - ia
                    for j in range(items):
                        take_a = ib >= len(tb) or (ia < len(ta)
                                                   and not tb[ib] < ta[ia])
                        nxt[o0 + t + j] = ta[ia] if take_a else tb[ib]
                        ia, ib = ia + take_a, ib + (not take_a)
            keys, width = nxt, 2 * width
        idx = (keys[:k] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        out_v.append(row[idx])
        out_i.append(idx.astype(np.int32))
    return np.stack(out_v), np.stack(out_i)


@pytest.mark.parametrize("b,n,k", [(2, 65536, 32768), (1, 65536, 65536),
                                   (1, 40000, 20000)])
def test_merge_model_matches_lax_top_k(b, n, k):
    """The model of merge mode (select, run sorts, tiled merge passes)
    equals lax.top_k of the negated row and the plain version on tie-heavy
    rows: ties at the cut, across run boundaries and at the tiles' split
    points, +inf tails, and the (+inf, INT_MAX) padding of k < len."""
    rng = np.random.default_rng(b * n + k)
    x = _tie_heavy(rng, b, n)
    got_v, got_i = _merge_model(x, k, seed=k)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), k)
    np.testing.assert_array_equal(got_v, -np.asarray(neg))
    np.testing.assert_array_equal(got_i, np.asarray(lax_i))
    plain_v, plain_i = bitonic_topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v, plain_v.numpy())
    np.testing.assert_array_equal(got_i, plain_i.numpy())


def _digit_cut(hist_of, k):
    """(prefix, shift, need) of the k-th smallest key, by 8-bit digits from
    the top as csrc/topk.cu finds it, stopping once its bucket is taken
    whole; hist_of(prefix, shift, lo) is the histogram of digit [lo, lo + 8)
    of the live keys (bits [shift, 32) equal to prefix's)."""
    bits = prim.TOPK_DIGIT_BITS
    prefix, shift, need = 0, 32, k
    while shift > 0:
        lo = shift - bits
        hist = hist_of(prefix, shift, lo)
        incl = np.cumsum(hist)
        bucket = int(np.searchsorted(incl, need))   # first incl >= need
        before = int(incl[bucket] - hist[bucket])
        prefix |= bucket << lo
        need -= before
        shift = lo
        if need == hist[bucket]:
            break
    return prefix, shift, need


def _slice_hist(key, prefix, shift, lo):
    bins = 1 << prim.TOPK_DIGIT_BITS
    live = (key >> shift) == (prefix >> shift) if shift < 32 else \
        np.ones(key.size, bool)
    return np.bincount((key[live] >> lo) & (bins - 1), minlength=bins)


def _survivors(key, cut, shift, need, tiebase, first):
    """Kernel A's slots for one slice's survivors, as the cluster route
    compacts them in position order: every key below the cut, then the
    ties whose rank in the row (the ties of the earlier slices, tiebase,
    then this slice's in position order) is below `need`.  Returns (local
    positions, slots)."""
    hi = key >> shift
    below, tie = hi < cut, hi == cut
    below_before = np.cumsum(below) - below       # exclusive, in order
    ties_before = np.cumsum(tie) - tie
    take = below | (tie & (tiebase + ties_before < need))
    slot = (first + below_before + np.minimum(need, tiebase + ties_before)
            - min(need, tiebase))
    return np.flatnonzero(take), slot[take]


def _cluster_model(x, k):
    """The cluster route as csrc/topk.cu runs it, row by row and slice by
    slice: C slices of ceil(n / C) elements, rounded up to whole blocks.
    Select mode: each slice's own k smallest (its digit cut from its own
    histograms, its ties in position order), block 0's C x k candidates
    sorted by (value, position).  Merge mode: the row's cut from the sum of
    the slices' histograms, the cross-slice tie base and first slot of
    every slice, the survivors scattered per_k a block, then four stable
    radix passes of 8 bits over the blocks' pairs: each block ranks its
    pairs a warp at a time, partitions them by digit, and its run of every
    digit goes to the digit-major, block-minor offset of the cluster (a
    pass in which one digit holds every key is skipped)."""
    n = x.shape[1]
    plan = prim._topk_plan(n, k)
    assert plan.cluster, plan
    C, T, bins = plan.cluster, plan.threads, 1 << prim.TOPK_DIGIT_BITS
    piece = -(-(-(-n // C)) // T) * T
    assert piece <= plan.items * T
    warps = T // 32
    out_v, out_i = [], []
    for row in x:
        key = _float_keys(row).astype(np.int64)
        spans = [(min(n, r * piece), min(n, (r + 1) * piece))
                 for r in range(C)]
        if plan.mode == "select":
            cands = []
            for a, b in spans:
                kept = min(k, b - a)
                if kept == b - a:                  # the slice whole
                    cands.append(np.arange(a, b))
                    continue
                prefix, shift, need = _digit_cut(
                    lambda p, s, lo: _slice_hist(key[a:b], p, s, lo), kept)
                local, slot = _survivors(key[a:b], prefix >> shift, shift,
                                         need, 0, 0)
                assert np.array_equal(np.sort(slot), np.arange(kept))
                cands.append(a + local)
            cand = np.concatenate(cands)
            assert cand.size <= plan.sort_len
            order = np.lexsort((cand, row[cand]))  # (value, position)
            out_i.append(cand[order[:k]].astype(np.int32))
            out_v.append(row[cand[order[:k]]])
            continue
        per_k = plan.sort_len
        if k == n:
            prefix, shift, need, cut = 0, 0, 0, 1 << 32   # all below
        else:
            prefix, shift, need = _digit_cut(
                lambda p, s, lo: sum(_slice_hist(key[a:b], p, s, lo)
                                     for a, b in spans), k)
            cut = prefix >> shift
        blocks = np.zeros((C, per_k), np.int64)            # positions
        filled = np.zeros(C * per_k, bool)
        tiebase = first = 0
        for a, b in spans:
            hi = key[a:b] >> shift
            local, slot = _survivors(key[a:b], cut, shift, need, tiebase,
                                     first)
            blocks.reshape(-1)[slot] = a + local
            assert not filled[slot].any()
            filled[slot] = True
            ties = int((hi == cut).sum())
            first += int((hi < cut).sum()) + min(max(need - tiebase, 0),
                                                 ties)
            tiebase += ties
        assert first == k and filled[:k].all() and not filled[k:].any()
        held = [min(max(k - r * per_k, 0), per_k) for r in range(C)]
        runs = [blocks[r, :held[r]] for r in range(C)]
        chunk = per_k // warps
        for lo in range(0, 32, prim.TOPK_DIGIT_BITS):
            digits = [(_float_keys(row[run]).astype(np.int64) >> lo)
                      & (bins - 1) for run in runs]
            counts = np.stack([np.bincount(d, minlength=bins)
                               for d in digits])           # (C, bins)
            total = counts.sum(0)
            if (total == k).any():
                continue                   # one digit holds every key
            goff = (np.cumsum(total) - total)[None, :] + \
                np.cumsum(counts, 0) - counts
            lstart = np.cumsum(counts, 1) - counts
            dest = np.empty(k, np.int64)
            for r, d in enumerate(digits):
                # a warp's rank among its chunk's equal digits, then the
                # warps' exclusive starts: a stable partition by digit
                w = np.arange(d.size) // chunk
                wcount = np.zeros((warps, bins), np.int64)
                rank = np.empty(d.size, np.int64)
                for e in range(d.size):
                    rank[e] = wcount[w[e], d[e]]
                    wcount[w[e], d[e]] += 1
                wstart = np.cumsum(wcount, 0) - wcount
                t = lstart[r, d] + wstart[w, d] + rank
                assert np.array_equal(np.sort(t), np.arange(d.size))
                assert np.array_equal(np.argsort(t), np.argsort(
                    d, kind="stable"))
                dest[goff[r, d] + t - lstart[r, d]] = runs[r]
            runs = [dest[r * per_k:r * per_k + held[r]] for r in range(C)]
        idx = np.concatenate(runs)
        out_i.append(idx.astype(np.int32))
        out_v.append(row[idx])
    return np.stack(out_v), np.stack(out_i)


@pytest.mark.parametrize("b,n,k", [(2, 65536, 32768), (1, 65536, 65536),
                                   (1, 40000, 20000), (2, 65536, 256),
                                   (1, 70001, 20000), (2, 70001, 256),
                                   (2, 20000, 100)])
def test_cluster_model_matches_lax_top_k(b, n, k):
    """The model of the cluster route (select and merge mode on rows above
    16384 elements) equals lax.top_k of the negated row and the plain
    version to the bit on tie-heavy rows: ties at the cut across the
    slices, k = n, rows that are no multiple of a slice, +inf tails."""
    rng = np.random.default_rng(b * n + k + 1)
    x = _tie_heavy(rng, b, n)
    got_v, got_i = _cluster_model(x, k)
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), k)
    np.testing.assert_array_equal(got_v, -np.asarray(neg))
    np.testing.assert_array_equal(got_i, np.asarray(lax_i))
    plain_v, plain_i = bitonic_topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v, plain_v.numpy())
    np.testing.assert_array_equal(got_i, plain_i.numpy())


@pytest.mark.parametrize("k", [256, 40000])
def test_cluster_model_on_signed_zeros(k):
    """-0.0 and +0.0 share one key on the cluster route too: they tie, come
    out lowest position first like the plain version's, and keep their own
    sign bits."""
    rng = np.random.default_rng(k)
    x = np.where(rng.random((1, 65536)) < 0.5, 0.0, -0.0).astype(np.float32)
    x[:, ::7] = -1.0
    got_v, got_i = _cluster_model(x, k)
    plain_v, plain_i = bitonic_topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i, plain_i.numpy())
    np.testing.assert_array_equal(np.signbit(got_v),
                                  np.signbit(plain_v.numpy()))


@pytest.mark.parametrize("n", [16385, 40000, 65536, 70001,
                               prim.TOPK_CLUSTER_MAX_ROW])
def test_topk_plan_takes_the_cluster_route(n):
    """Rows above 16384 elements and up to C x 16384 take the cluster route
    in merge mode and in select mode up to TOPK_CLUSTER_SELECT_MAX_K, on
    the smallest cluster that holds them; longer rows, larger selects and
    the forced one-block route take one block a row."""
    C = next(c for c in prim.TOPK_CLUSTER_SIZES if n <= c * 16384)
    assert prim._topk_plan(n, 256).cluster == C
    assert prim._topk_plan(n, 256, cluster=0).cluster == 0
    assert prim._topk_plan(n, 512).cluster == 0
    k = max(16385, n // 2)
    assert prim._topk_plan(n, k) == prim._cluster_plan(n, k, "merge")
    assert prim._topk_plan(n, k).cluster >= C
    for bigger in (n + 1, 2 * n):
        if bigger > prim.TOPK_CLUSTER_MAX_ROW:
            assert prim._topk_plan(bigger, 256).cluster == 0
            assert prim._topk_plan(bigger, bigger // 2).cluster == 0
    with pytest.raises(NotImplementedError):
        prim._topk_plan(prim.TOPK_CLUSTER_MAX_ROW + 1, 256, cluster=8)
    with pytest.raises(NotImplementedError):
        prim._topk_plan(n, n, cluster=4) if n > 4 * 8192 else \
            prim._topk_plan(n, 256, "sort", cluster=4)


@pytest.mark.parametrize("fill", [3.0, np.inf])
def test_select_model_on_constant_rows(fill):
    """Every key equal: all four digit passes run and the cut takes the
    first k positions."""
    x = np.full((2, 4096), fill, np.float32)
    got_v, got_i = _select_model(x, 128)
    np.testing.assert_array_equal(got_i, np.tile(np.arange(128), (2, 1)))
    np.testing.assert_array_equal(got_v, x[:, :128])


def test_topk_plain_matches_lax_top_k_on_sift1b_rows():
    """The plain version at SIFT1B_CONFIG's pair grid: (4, 65536) -> 256."""
    rng = np.random.default_rng(65536)
    x = np.round(rng.uniform(0, 50, (4, 65536))).astype(np.float32)
    x[:, ::11] = np.inf
    neg, lax_i = jax.lax.top_k(-jnp.asarray(x), 256)
    got_v, got_i = bitonic_topk(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(got_v.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(lax_i))


def test_topk_signed_zeros_are_one_key():
    """-0.0 and +0.0 share one key, so they tie and come out lowest
    position first, as in the plain version (torch.sort) and jnp.argsort;
    lax.top_k alone would order -0.0 first.  The port's inputs never hold
    -0.0 (clamped tables, sums of non-negative terms)."""
    zero = np.array([0.0, -0.0], np.float32)
    assert _float_keys(zero)[0] == _float_keys(zero)[1]
    assert _float_keys(np.array([-1e-30], np.float32))[0] < \
        _float_keys(zero)[0] < _float_keys(np.array([1e-30], np.float32))[0]
    x = np.array([[1.0, 0.0, -0.0, 0.0, -0.0, -0.0, 2.0, -1.0]], np.float32)
    want = [7, 1, 2, 3, 4, 5]
    _, model_i = _select_model(x, 6)
    _, plain_i = bitonic_topk_plain(torch.from_numpy(x), 6)
    assert model_i[0].tolist() == want
    assert plain_i[0].tolist() == want
    assert np.asarray(jnp.argsort(jnp.asarray(x[0]), stable=True)
                      )[:6].tolist() == want


@pytest.mark.parametrize("shape", [(8, 512), (1, 1 << 20), (3, 32768),
                                   (2, 70001)])
@pytest.mark.parametrize("exclusive", [False, True])
def test_block_scan_matches_pallas(shape, exclusive):
    rng = np.random.default_rng(shape[1])
    x = rng.integers(0, 100, shape).astype(np.int32)
    want = PP.block_scan(jnp.asarray(x), exclusive=exclusive, interpret=True)
    got = block_scan(torch.from_numpy(x), exclusive)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _random_payload(rng, n, lp):
    """test_pallas_rerank.py's generator: random compact payload rows."""
    a = rng.integers(0, 16, (n, lp)).astype(np.uint32)
    b = rng.integers(0, 16, (n, lp)).astype(np.uint32)
    lam8 = rng.integers(0, 256, (n, lp)).astype(np.uint32)
    codes = a | (b << 8) | ((lam8 << 8) << 16)
    ids = np.arange(n, dtype=np.int32)
    t3 = rng.normal(0, 1, n).astype(np.float32)
    return pack_payload_compact(ids, codes, t3)


@pytest.mark.parametrize("B,K,lp", [(4, 1024, 16), (2, 2048, 32),
                                    (3, 1000, 16)])
def test_rerank_matches_pallas(B, K, lp):
    """Row-major (B, K, W) rows, no multiple-of-1024 rule: the ragged K is
    compared against the Pallas kernel on rows padded to a whole block."""
    rng = np.random.default_rng(7 * K + lp)
    rows = np.stack([_random_payload(rng, K, lp) for _ in range(B)])
    q_line = rng.uniform(0.0, 50.0, (B, lp, 16)).astype(np.float32)
    k_pad = -(-K // BLOCK) * BLOCK
    rows_pad = np.concatenate(
        [rows, np.zeros((B, k_pad - K, rows.shape[2]), np.int32)], axis=1)
    q_pad = jnp.pad(jnp.asarray(q_line), ((0, 0), (0, 0), (0, 128 - 16)))
    want = np.asarray(pallas_rerank(
        jnp.asarray(rows_pad).transpose(0, 2, 1), q_pad,
        interpret=True))[:, :K]
    got = rerank_fused(torch.from_numpy(rows), torch.from_numpy(q_line))
    assert got.shape == (B, K)
    # the two sum the line parts in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c1,lp,lambda_bits", [(16, 16, 16), (256, 32, 16),
                                               (256, 8, 8)])
def test_rerank_wide_matches_jax_unpack(c1, lp, lambda_bits):
    """The wide layout (one uint32 a line part, A | B << 8 | lam_u16 << 16):
    rerank_fused(compact=False) equals the JAX package's
    unpack_payload_cfg + reconstruct_dists_idx, c1 up to 256."""
    rng = np.random.default_rng(c1 + lp)
    B, K = 3, 500
    a = rng.integers(0, c1, (B * K, lp)).astype(np.uint32)
    b = rng.integers(0, c1, (B * K, lp)).astype(np.uint32)
    lam = rng.integers(0, 65536, (B * K, lp)).astype(np.uint32)
    if lambda_bits == 8:
        lam &= np.uint32(0xFF00)
    rows = pack_payload(np.arange(B * K, dtype=np.int32), a | (b << 8)
                        | (lam << 16), rng.normal(0, 1, B * K)
                        ).reshape(B, K, 2 + lp)
    q_line = rng.uniform(0.0, 50.0, (B, lp, c1)).astype(np.float32)
    jcfg = PQTConfig(dim=lp * 4, p=4, c1=c1, c2=4, line_parts=lp,
                     k1_build=4, k1_query=4, payload_compact=False,
                     lambda_bits=lambda_bits)
    _, ja, jb, jlam, jt3 = unpack_payload_cfg(jcfg, jnp.asarray(rows))
    want = np.asarray(reconstruct_dists_idx(ja, jb, jlam,
                                            jnp.asarray(q_line), jt3))
    got = rerank_fused(torch.from_numpy(rows), torch.from_numpy(q_line),
                       compact=False)
    assert got.shape == (B, K)
    # the two sum the line parts in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        rerank_fused(torch.from_numpy(rows), torch.from_numpy(q_line))


@pytest.mark.parametrize("shape,parts", [((8, 128), 4), ((16, 128), 16),
                                         ((8, 96), 1)])
def test_segmented_reduce_matches_pallas(shape, parts):
    rng = np.random.default_rng(shape[0] * parts)
    x = rng.normal(0, 1, shape).astype(np.float32)
    want = PP.segmented_reduce(jnp.asarray(x), parts, interpret=True)
    got = segmented_reduce(torch.from_numpy(x), parts)
    assert got.shape == (shape[0], parts) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def micro_gather():
    """benchmarks/micro_gather{,2}.py as modules.  micro_gather2 turns on
    the persistent compile cache when it is imported; the flag that says it
    is on already is set for the import, so the worker's JAX config stays
    as it was."""
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pqt_tpu.utils.cache, "_enabled", True)
        for name in ("micro_gather", "micro_gather2"):
            spec = importlib.util.spec_from_file_location(
                f"_bench_{name}", BENCHMARKS / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods[name] = mod
    return mods


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run every pl.pallas_call of the benchmark kernels in interpret mode
    (they take no `interpret` argument)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("kernel", ["pallas_gather", "pallas_lut_2d",
                                    "pallas_lut_onehot"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_lut_gather_matches_pallas_lookups(micro_gather, pallas_interpret,
                                           kernel, dtype):
    """The E, F and G lookups, at a (2^14,) int32 (counts, prefix) or
    uint8 (pair occupancy) table and (16, 256) indices; every one equals
    lut_gather exactly."""
    mod = micro_gather["micro_gather" if kernel == "pallas_gather"
                       else "micro_gather2"]
    rng = np.random.default_rng(14)
    table = rng.integers(0, np.iinfo(dtype).max, 1 << 14).astype(dtype)
    idx = rng.integers(0, 1 << 14, (16, 256)).astype(np.int32)
    want = np.asarray(getattr(mod, kernel)(jnp.asarray(table),
                                           jnp.asarray(idx)))
    got = lut_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.numpy().dtype == dtype and got.shape == idx.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, table[idx])


def test_lut_gather_uint8_table():
    """The pair-occupancy lookup: a uint8 table, indices of any shape."""
    rng = np.random.default_rng(8)
    table = rng.integers(0, 2, 2 * 65536).astype(np.uint8)
    idx = rng.integers(0, table.size, (4, 2, 256)).astype(np.int32)
    got = lut_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("dtype,width", [(np.int32, 10), (np.uint8, 128)])
def test_gather_rows_matches_pallas_dma_gather(micro_gather,
                                               pallas_interpret, dtype,
                                               width):
    """H: a (4096, 10) int32 table (the compact payload's rows) or a
    (4096, 128) uint8 one (SIFT vectors), (4, 64) positions, 8 copies in
    flight."""
    rng = np.random.default_rng(width)
    info = np.iinfo(dtype)
    tab = rng.integers(info.min, info.max, (4096, width)).astype(dtype)
    pos = rng.integers(0, 4096, (4, 64)).astype(np.int32)
    want = np.asarray(micro_gather["micro_gather2"].pallas_dma_gather(
        jnp.asarray(tab), jnp.asarray(pos), inflight=8))
    got = gather_rows(torch.from_numpy(tab), torch.from_numpy(pos))
    assert got.shape == (4, 64, width) and got.numpy().dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype,width", [(np.uint8, 128), (np.int32, 2),
                                         (np.float32, 32)])
@pytest.mark.parametrize("span", [1, 4])
def test_gather_rows_any_dtype_and_span(dtype, width, span):
    """uint8 vectors, (start, end) extent rows and float rows; with a span,
    `span` consecutive rows from each position (slab mode)."""
    rng = np.random.default_rng(width + span)
    tab = rng.integers(0, 255, (300, width)).astype(dtype)
    pos = rng.integers(0, 300 - span, (5, 7)).astype(np.int32)
    got = gather_rows(torch.from_numpy(tab), torch.from_numpy(pos), span)
    want = tab[pos[..., None] + np.arange(span)]
    if span == 1:
        want = want[..., 0, :]
    assert got.dtype == torch.from_numpy(tab).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Non-contiguous or non-int32 indices are refused on the CPU too, so
    the CPU runs catch a caller that would fail on the card."""
    table = torch.arange(64, dtype=torch.int32)
    idx = torch.arange(16, dtype=torch.int32).reshape(4, 4)
    with pytest.raises(ValueError):
        lut_gather(table, idx.T)
    with pytest.raises(ValueError):
        lut_gather(table, idx.long())
    with pytest.raises(ValueError):
        gather_rows(table.reshape(16, 4), idx[:, :2])
    with pytest.raises(ValueError):
        segmented_reduce(torch.ones((4, 6)), 4)
    with pytest.raises(ValueError):
        segmented_reduce(torch.ones((4, 8)).T, 2)
