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
    """Merge mode as csrc/topk.cu runs it, row by row: the select's k
    survivors in any order (the whole row for k = n) in a scratch row of
    len pairs, runs of TOPK_SORT_MAX sorted by (value, index), then merge
    passes in which every 4096-pair tile finds its split points by
    merge_path and each of its 512 threads merges 8 outputs from a split of
    its own."""
    rng = np.random.default_rng(seed)
    n = x.shape[1]
    plan = prim._topk_plan(n, k)
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
