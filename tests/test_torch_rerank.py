"""Kernel C's line re-rank by position (`gather_rerank`, csrc/rerank.cu):
its plain version against the JAX package (the Pallas `rerank_fused` in
interpret mode, and `unpack_payload_cfg` + `reconstruct_dists_idx`), a
numpy model of its launch plan, and the routing of every line re-rank
through it.

The CUDA kernel runs only on the card (chip_smoke.py holds it against the
plain version there).  What the CPU can check is the arithmetic around it:
the plain version's ids and distances, and that the plan's block -> (query,
tiles) and thread -> (row, unit) mappings, walked as the kernel walks them,
write every candidate exactly once from a staged copy of exactly its row.
Inputs are made with numpy from a seed.

Tolerance: the kernel and the plain version sum a row's line parts in
different orders (the kernel from t3 up in ascending line part, the plain
version the parts first, then t3), as does the Pallas kernel, so distances
agree within rtol 1e-5, atol 1e-4; ids are equal to the bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pqt_tpu.config import PQTConfig
from pqt_tpu.models.db import (pack_payload, pack_payload_compact,
                               unpack_payload_cfg)
from pqt_tpu.ops.linecodes import reconstruct_dists_idx
from pqt_tpu.ops.pallas.rerank import BLOCK, rerank_fused as pallas_rerank
import pqt_tpu_torch as T
from pqt_tpu_torch.models import query as TQ
from pqt_tpu_torch.models.db import PQTDatabase
from pqt_tpu_torch.models.tree import line_tables
from pqt_tpu_torch.ops import binning as TBIN
from pqt_tpu_torch.ops.cuda import rerank as rr

RTOL, ATOL = 1e-5, 1e-4


def _payload(rng, n, lp, c1=16, compact=True, lambda_bits=16):
    """Random payload rows packed by the JAX package (ids 1000 + row), with
    lambda in [-0.5, 1.5) as the build gives it: a projection inside or
    near its segment (the compact layout keeps 8 bits of it)."""
    a = rng.integers(0, c1, (n, lp)).astype(np.uint32)
    b = rng.integers(0, c1, (n, lp)).astype(np.uint32)
    lam = rng.integers(28672, 45056, (n, lp)).astype(np.uint32)
    if compact or lambda_bits == 8:
        lam &= np.uint32(0xFF00)
    codes = a | (b << 8) | (lam << 16)
    ids = np.arange(1000, 1000 + n, dtype=np.int32)
    t3 = rng.normal(0, 1, n).astype(np.float32)
    if compact:
        return pack_payload_compact(ids, codes, t3)
    return pack_payload(ids, codes, t3)


def _positions(rng, n, B, K, mode):
    """(positions (B, K) int32 inside [0, n), valid (B, K) bool): uniform
    rows with every third slot invalid and rows 0 and n - 1 among them, or
    slab windows of 16 consecutive rows (validity a prefix of each)."""
    if mode == "slabs":
        S = 16
        starts = rng.integers(0, n - S + 1, (B, -(-K // S)))
        starts[0, 0] = n - S
        pos = (starts[..., None] + np.arange(S)).reshape(B, -1)[:, :K]
        fill = rng.integers(0, S + 1, starts.shape)
        valid = (np.arange(S) < fill[..., None]).reshape(B, -1)[:, :K]
    else:
        pos = rng.integers(0, n, (B, K))
        pos[0, :2] = (0, n - 1)[:K]
        valid = np.ones((B, K), bool)
        valid[:, ::3] = False
    return pos.astype(np.int32), np.ascontiguousarray(valid)


def _run(payload, pos, valid, q, compact):
    ids, dists = rr.gather_rerank(torch.from_numpy(payload),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(valid),
                                  torch.from_numpy(q), compact)
    assert ids.dtype == torch.int32 and dists.dtype == torch.float32
    return ids.numpy(), dists.numpy()


def _assert_dists(got, want, valid):
    assert got.shape == want.shape
    assert np.isinf(got[~valid]).all() and np.isfinite(got[valid]).all()
    np.testing.assert_allclose(got[valid], want[valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,K,lp,mode", [
    (3, 1000, 16, "rows"), (2, 1, 16, "rows"), (2, 257, 32, "rows"),
    (1, 1024, 32, "slabs"), (2, 700, 16, "slabs")])
def test_gather_rerank_matches_pallas(B, K, lp, mode):
    """The compact layout at ragged K, slab windows and invalid slots,
    against the Pallas kernel over payload[pos] transposed to (B, W, K)
    (K padded to a whole block) with lane-padded tables; ids are the rows'
    id column, invalid slots included."""
    rng = np.random.default_rng(K + lp)
    n = 3000
    payload = _payload(rng, n, lp)
    pos, valid = _positions(rng, n, B, K, mode)
    q = rng.uniform(0.0, 50.0, (B, lp, 16)).astype(np.float32)
    rows = payload[pos]
    k_pad = -(-K // BLOCK) * BLOCK
    rows_pad = np.concatenate(
        [rows, np.zeros((B, k_pad - K, rows.shape[2]), np.int32)], axis=1)
    q_pad = jnp.pad(jnp.asarray(q), ((0, 0), (0, 0), (0, 128 - 16)))
    want = np.asarray(pallas_rerank(jnp.asarray(rows_pad).transpose(0, 2, 1),
                                    q_pad, interpret=True))[:, :K]
    ids, dists = _run(payload, pos, valid, q, True)
    np.testing.assert_array_equal(ids, payload[pos, 0])
    _assert_dists(dists, want, valid)


@pytest.mark.parametrize("c1,lp,lambda_bits", [
    (16, 16, 16), (16, 32, 8), (256, 32, 16), (256, 8, 8), (256, 64, 16),
    (256, 64, 8)])
def test_gather_rerank_wide_matches_jax_unpack(c1, lp, lambda_bits):
    """The wide layout against the JAX package's unpack_payload_cfg +
    reconstruct_dists_idx of the same rows, c1 up to 256; at lp 64 the
    (lp, c1) table is 64 KB, above the 48 KB an earlier kernel took."""
    rng = np.random.default_rng(c1 + lp + lambda_bits)
    B, K, n = 3, 333, 2000
    payload = _payload(rng, n, lp, c1, False, lambda_bits)
    pos, valid = _positions(rng, n, B, K, "rows")
    q = rng.uniform(0.0, 50.0, (B, lp, c1)).astype(np.float32)
    jcfg = PQTConfig(dim=lp * 4, p=4, c1=c1, c2=4, line_parts=lp,
                     k1_build=4, k1_query=4, payload_compact=False,
                     lambda_bits=lambda_bits)
    _, ja, jb, jlam, jt3 = unpack_payload_cfg(jcfg, jnp.asarray(payload[pos]))
    want = np.asarray(reconstruct_dists_idx(ja, jb, jlam, jnp.asarray(q),
                                            jt3))
    ids, dists = _run(payload, pos, valid, q, False)
    np.testing.assert_array_equal(ids, payload[pos, 0])
    _assert_dists(dists, want, valid)
    # rerank_fused over the gathered rows is the same function
    got = rr.rerank_fused(torch.from_numpy(payload[pos]), torch.from_numpy(q),
                          compact=False).numpy()
    np.testing.assert_allclose(got[valid], dists[valid], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["all_invalid", "first_and_last_row",
                                  "outside_the_payload", "no_candidates",
                                  "one_query_one_candidate"])
def test_gather_rerank_edges(case):
    """Every slot invalid (ids still read), rows 0 and N - 1 only,
    positions outside the payload (id 0, +inf, as the JAX package pads a
    slab window past a payload shorter than a slab), K = 0, and B = K = 1."""
    rng = np.random.default_rng(3)
    n, lp = 50, 16
    payload = _payload(rng, n, lp)
    pos, valid = _positions(rng, n, 2, 40, "rows")
    if case == "all_invalid":
        valid[:] = False
    elif case == "first_and_last_row":
        pos[:] = np.where(np.arange(40) % 2, n - 1, 0)
    elif case == "outside_the_payload":
        pos[:, :4] = (-1, n, n + 7, -100)
    elif case == "no_candidates":
        pos, valid = pos[:, :0].copy(), valid[:, :0].copy()
    else:
        pos, valid = pos[:1, :1].copy(), np.ones((1, 1), bool)
    q = rng.uniform(0.0, 50.0, (pos.shape[0], lp, 16)).astype(np.float32)
    ids, dists = _run(payload, pos, valid, q, True)
    inside = (pos >= 0) & (pos < n)
    np.testing.assert_array_equal(
        ids, np.where(inside, payload[np.where(inside, pos, 0), 0], 0))
    live = valid & inside
    rows = payload[np.where(inside, pos, 0)]
    want = rr.rerank_plain(torch.from_numpy(rows), torch.from_numpy(q)).numpy()
    _assert_dists(dists, want, live)


def test_gather_rerank_refuses_what_the_kernel_does_not_take():
    """Checked on the CPU too, so a CPU run catches a caller the card would
    refuse; a tensor on neither the CPU nor a card is refused."""
    payload = torch.zeros((20, 10), dtype=torch.int32)
    pos = torch.zeros((2, 5), dtype=torch.int32)
    valid = torch.ones((2, 5), dtype=torch.bool)
    q = torch.zeros((2, 16, 16))
    for args in ((payload.float(), pos, valid, q),
                 (payload, pos.long(), valid, q),
                 (payload, torch.zeros((5, 2), dtype=torch.int32).T, valid, q),
                 (payload, pos, valid.int(), q),
                 (payload, pos, valid[:1], q),
                 (payload, pos, valid, q[:, :8]),          # lp 8: W = 6
                 (payload, pos, valid, q.double()),
                 (payload, pos, valid, q[:1]),
                 (payload[:, :9], pos, valid, q),
                 (payload.to("meta"), pos.to("meta"), valid.to("meta"),
                  q.to("meta"))):
        with pytest.raises(ValueError):
            rr.gather_rerank(*args)
    with pytest.raises(ValueError):                      # c1 32, compact
        rr.gather_rerank(payload, pos, valid, torch.zeros((2, 16, 32)))


# ---------------------------------------------------------------------------
# the launch plan, walked on numpy as csrc/rerank.cu walks it
# ---------------------------------------------------------------------------

def _copy_walk(upr):
    """Each thread's (row, unit) sequence of a tile copy, by the kernel's
    division-free walk: (rows (256, upr), units (256, upr))."""
    tid = np.arange(rr.RERANK_THREADS)
    step_r, step_u = divmod(rr.RERANK_THREADS, upr)
    r, u = tid // upr, tid % upr
    rs, us = [], []
    for _ in range(upr):
        rs.append(r.copy())
        us.append(u.copy())
        r, u = r + step_r, u + step_u
        carry = u >= upr
        u, r = np.where(carry, u - upr, u), np.where(carry, r + 1, r)
    return np.stack(rs, 1), np.stack(us, 1)


def _line_dists(words, lp, c1, q, compact):
    """The kernel's per-row arithmetic in float32: acc = t3, then each
    term (1 - lam) * qa + lam * qb in ascending line part.  words (R, W)
    uint32, q (lp, c1)."""
    acc = words[:, 1].copy().view(np.float32)
    for j in range(lp):
        if compact:
            half = (words[:, 2 + j // 2] >> np.uint32(16 * (j % 2))) & 0xFFFF
            a, b = half & 0xF, (half >> 4) & 0xF
            lam = ((half >> 8) & 0xFF).astype(np.float32) * np.float32(
                0.03125) - np.float32(4)
        else:
            w = words[:, 2 + j]
            a, b = w & 0xFF, (w >> 8) & 0xFF
            lam = (w >> 16).astype(np.float32) * np.float32(
                1 / 8192) - np.float32(4)
        acc = acc + ((np.float32(1) - lam) * q[j, a] + lam * q[j, b])
    return acc


def _rerank_model(plan, payload, addr, pos, valid, q, compact):
    """csrc/rerank.cu walked on numpy: every block's run of tiles, each
    staged tile copied unit by unit into a buffer that held the previous
    tile's rows, then decoded.  Returns (ids, dists, writes per candidate)
    and checks every copy's alignment."""
    N, W = payload.shape
    B, K = pos.shape
    _, lp, c1 = q.shape
    n_tiles = -(-K // rr.RERANK_THREADS)
    ids = np.full((B, K), -7, np.int32)
    dists = np.full((B, K), np.nan, np.float32)
    writes = np.zeros((B, K), np.int64)
    src = payload.view(np.uint8).reshape(N, 4 * W)
    if plan.staged:
        upr = 4 * W // plan.unit
        rows_of, units_of = _copy_walk(upr)
        cover = np.zeros((rr.RERANK_THREADS, upr), np.int64)
        np.add.at(cover, (rows_of.ravel(), units_of.ravel()), 1)
        assert (cover == 1).all()
        byte = (units_of.ravel()[:, None] * plan.unit
                + np.arange(plan.unit)[None])          # (copies, unit)
        row = np.repeat(rows_of.ravel(), plan.unit).reshape(byte.shape)
    for block in range(B * plan.chunks):
        b, chunk = divmod(block, plan.chunks)
        t0 = chunk * plan.per_chunk
        t1 = min(t0 + plan.per_chunk, n_tiles)
        assert t0 < t1
        buffers = np.full((2, rr.RERANK_THREADS, 4 * W), 0xAB, np.uint8)
        for t in range(t0, t1):
            k = t * rr.RERANK_THREADS + np.arange(rr.RERANK_THREADS)
            p = np.where(k < K, pos[b, np.minimum(k, K - 1)], -1)
            inside = (p >= 0) & (p < N)
            if plan.staged:
                buf = buffers[(t - t0) & 1]
                copy = inside[row[:, 0]]
                src_addr = addr + p[row[copy, 0]] * 4 * W + byte[copy, 0]
                assert (src_addr % plan.unit == 0).all()
                assert ((row[copy, 0] * 4 * W + byte[copy, 0]) % plan.unit
                        == 0).all()
                buf[row[copy], byte[copy]] = src[p[row[copy]], byte[copy]]
                words = buf.view(np.uint32)
            else:
                words = src[np.where(inside, p, 0)].view(np.uint32)
            live = k < K
            kk = k[live]
            ids[b, kk] = np.where(inside[live], words[live, 0].view(np.int32),
                                  0)
            # the kernel decodes a row only inside the payload and valid
            dec = inside[live] & valid[b, kk]
            dists[b, kk] = np.inf
            dists[b, kk[dec]] = _line_dists(words[live][dec], lp, c1, q[b],
                                            compact)
            writes[b, kk] += 1
    return ids, dists, writes


def _plan_cases():
    for lp in range(2, 65):
        yield True, lp, 16
    for lp in range(1, 65):
        for c1 in (16, 256):
            yield False, lp, c1


@pytest.mark.parametrize("offset", [0, 4, 8])
def test_rerank_plan_writes_every_candidate_once(offset):
    """For every compact lp 2-64 and every wide lp 1-64 at c1 16 and 256,
    a payload 0, 4 or 8 bytes past a 16-byte boundary, ragged K and
    positions outside the payload: the unit is the widest of 16, 8, 4
    bytes dividing the row and the address; the shared memory the plan
    asks for is the kernel's layout and at most 227 KB; the copy walk
    covers every unit of a tile once; and the kernel's walk, in the
    planned grid, in one block a query and in two, writes every candidate
    once, the id and distance of exactly its row."""
    rng = np.random.default_rng(offset)
    B, K, n = 2, 600, 40
    for compact, lp, c1 in _plan_cases():
        payload = _payload(rng, n, lp, c1, compact)
        W = payload.shape[1]
        pos = rng.integers(0, n, (B, K)).astype(np.int32)
        pos[0, :3] = (-1, n, n - 1)
        valid = rng.random((B, K)) < 0.7
        q = rng.uniform(0, 50, (B, lp, c1)).astype(np.float32)
        addr = 4096 + offset
        plan = rr._rerank_plan(B, K, W, lp, c1, addr, 132)
        unit = next(v for v in (16, 8, 4) if 4 * W % v == 0 and addr % v == 0)
        assert plan.unit == unit
        staging = 2 * rr.RERANK_THREADS * (4 * W + 4)
        assert plan.staged == (staging <= rr.RERANK_SMEM_MAX)
        assert plan.smem == staging * plan.staged + 4 * lp * c1 * \
            plan.table_smem <= rr.RERANK_SMEM_MAX
        want_ids, want_d = rr.gather_rerank_plain(
            torch.from_numpy(payload), torch.from_numpy(pos),
            torch.from_numpy(valid), torch.from_numpy(q), compact)
        tiles = -(-K // rr.RERANK_THREADS)
        for p in (plan, plan._replace(chunks=1, per_chunk=tiles),
                  plan._replace(chunks=2, per_chunk=2)):
            ids, dists, writes = _rerank_model(p, payload, addr, pos, valid,
                                               q, compact)
            assert (writes == 1).all(), (compact, lp, c1, p)
            np.testing.assert_array_equal(ids, want_ids.numpy())
            np.testing.assert_allclose(dists, want_d.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_rerank_plan_picks_the_shapes_of_the_paths():
    """SIFT1M compact (256, 1024) x 40 B: 8 blocks an SM, four one-tile
    blocks a query; SIFT1B compact (64, 8192) x 72 B and wide at c1 256
    (136 B rows, a 32 KB table): several tiles a block with the table
    loaded once; a 64 KB table still in shared memory; a 100 KB table
    beside 102-word rows from global memory; 242-word rows (a 240 KB table)
    unstaged."""
    plan = rr._rerank_plan(256, 1024, 10, 16, 16, 0, 132)
    assert plan == rr.RerankPlan(True, 8, True, 2 * 256 * 44 + 1024, 4, 1)
    plan = rr._rerank_plan(64, 8192, 18, 32, 16, 0, 132)
    assert plan[:4] == (True, 8, True, 2 * 256 * 76 + 2048)
    assert plan.chunks * plan.per_chunk >= 32 and plan.per_chunk >= 3
    plan = rr._rerank_plan(64, 8192, 34, 32, 256, 0, 132)
    assert plan[:4] == (True, 8, True, 2 * 256 * 140 + 32768)
    assert plan.chunks == 4 and plan.per_chunk == 8
    assert rr._rerank_plan(64, 8192, 66, 64, 256, 0, 132)[:3] == (
        True, 8, True)
    assert rr._rerank_plan(8, 1000, 102, 100, 256, 0, 132)[:3] == (
        True, 8, False)
    assert rr._rerank_plan(8, 1000, 242, 240, 256, 0, 132)[:3:2] == (
        False, False)
    # more queries than the card holds blocks: one block a query
    assert rr._rerank_plan(5000, 8192, 18, 32, 16, 0, 132)[4:] == (1, 32)
    with pytest.raises(ValueError):
        rr._rerank_plan(0, 8, 10, 16, 16, 0, 132)


# ---------------------------------------------------------------------------
# routing: every line re-rank reads its payload rows through gather_rerank
# ---------------------------------------------------------------------------

ROUTE_CFG = T.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8,
                        hash_size=1 << 16, k1_build=4, k1_query=4,
                        max_bins=64, bin_enum_factor=4, max_candidates=256,
                        max_vec_per_bin=64, kmeans_iters=3, pair_top_m=16)
SLABS = dict(gather_mode="slabs", slab_size=16)


@pytest.fixture(scope="module")
def route_db(clustered_data):
    db_vecs, queries = clustered_data
    tree = T.train_tree(ROUTE_CFG, db_vecs[:1024], device="cpu")
    db = T.build_database(ROUTE_CFG, tree, db_vecs[:1024], device="cpu",
                          keep_vectors=True)
    csr_only = PQTDatabase(*db[:4], vectors=None, prefix2=db.prefix2,
                           vectors_csr=db.vectors[db.ids.long()])
    return tree, db, csr_only, torch.from_numpy(queries[:6])


# (entry point, line re-ranks it runs)
LINE_ENTRY_POINTS = {
    "pair_line": (lambda c, t, db, csr, q: T.query_knn(c, t, db, q, 5), 1),
    "parts_line": (lambda c, t, db, csr, q: T.query_knn(
        c.replace(pipeline="parts"), t, db, q, 5), 1),
    "pair_slabs_line": (lambda c, t, db, csr, q: T.query_knn(
        c.replace(**SLABS), t, db, q, 5), 1),
    "parts_slabs_line": (lambda c, t, db, csr, q: T.query_knn(
        c.replace(pipeline="parts", **SLABS), t, db, q, 5), 1),
    "big_line": (lambda c, t, db, csr, q: T.query_big_knn(c, t, db, q, 5,
                                                          32), 1),
    "big_perfect": (lambda c, t, db, csr, q: T.query_big_knn_perfect(
        c, t, db, q, 5, 4, 32), 1),
    "pair_exact_by_id": (lambda c, t, db, csr, q: T.query_knn(
        c, t, db, q, 5, exact_rerank=True), 1),
    "pair_refine": (lambda c, t, db, csr, q: T.query_knn_refine(
        c, t, db, q, 5), 1),
    "parts_refine_vectors_csr": (lambda c, t, db, csr, q: T.query_knn_refine(
        c.replace(pipeline="parts"), t, csr, q, 5), 1),
    "pair_candidates": (lambda c, t, db, csr, q: T.query_candidates(
        c, t, db, q), 1),
    # the exact re-ranks that read no line distance (as in the JAX
    # package): the parts pipeline's by id and query_core_exact take the
    # candidates' ids from one payload-row gather (kernel H)
    "parts_exact_by_id": (lambda c, t, db, csr, q: T.query_knn(
        c.replace(pipeline="parts"), t, db, q, 5, exact_rerank=True), 0),
    "exact_vectors_csr": (lambda c, t, db, csr, q: T.query_knn(
        c, t, csr, q, 5, exact_rerank=True), 0),
    "exact_vectors_csr_slabs": (lambda c, t, db, csr, q: T.query_knn(
        c.replace(**SLABS), t, csr, q, 5, exact_rerank=True), 0),
}


@pytest.mark.parametrize("entry", sorted(LINE_ENTRY_POINTS))
def test_line_reranks_read_the_payload_once(route_db, entry, monkeypatch):
    """Pair and parts line, slabs, BIG line and BIG perfect, the pair
    pipeline's exact re-rank by id (its validity from the line distances),
    refine and the candidate set each call gather_rerank once on the
    payload and gather no payload row with kernel H first; the exact
    re-ranks that read no line distance gather the payload once, for ids."""
    tree, db, csr_only, q = route_db
    fn, n_line = LINE_ENTRY_POINTS[entry]
    reranks, gathered = [], []

    def counting(payload, positions, valid, q_line, compact=True):
        reranks.append(payload)
        return rr.gather_rerank(payload, positions, valid, q_line, compact)

    def gather_recorder(gather):
        def wrapped(tab, *args, **kw):
            gathered.append(tab)
            return gather(tab, *args, **kw)
        return wrapped

    monkeypatch.setattr(TQ, "gather_rerank", counting)
    for mod in (TQ, TBIN):
        monkeypatch.setattr(mod, "gather_rows",
                            gather_recorder(mod.gather_rows))
    res = fn(ROUTE_CFG, tree, db, csr_only, q)
    payloads = {db.payload.data_ptr()}
    assert len(reranks) == n_line
    assert all(t.data_ptr() in payloads for t in reranks)
    assert len([t for t in gathered if t.data_ptr() in payloads]) == \
        1 - n_line
    ids = res[0]                    # QueryResult.indices, or cand_ids
    assert ids.shape[0] == 6 and (ids[:, 0] >= 0).all()


@pytest.mark.parametrize("mode", ["rows", "slabs"])
def test_line_candidates_equal_the_rows_gathered_first(route_db, mode):
    """The pair pipeline's candidate set and line distances through
    gather_rerank equal the route it replaced: the payload rows gathered
    at the same positions, their id column, and rerank_fused over them
    with +inf where invalid."""
    tree, db, _, q = route_db
    cfg = ROUTE_CFG.replace(**SLABS) if mode == "slabs" else ROUTE_CFG
    cand_ids, line_d, _, pos = TQ.query_core_pair(
        cfg, tree, db.prefix2, db.payload, q, 0, pair_occ=db.pair_occ,
        want_candidates=True)
    rows = db.payload[pos.long()]
    np.testing.assert_array_equal(cand_ids.numpy(), rows[..., 0].numpy())
    valid = torch.isfinite(line_d)
    want = rr.rerank_fused(rows.contiguous(), line_tables(
        cfg, tree, q).contiguous(), cfg.payload_is_compact)
    np.testing.assert_allclose(line_d[valid].numpy(), want[valid].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert valid.any()
