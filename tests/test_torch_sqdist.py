"""The exact re-rank's distances, kernels H and D fused (`gather_sqdist`,
csrc/sqdist.cu), against the JAX package, and the exact entry points'
routing through it.

On a CPU tensor `gather_sqdist` runs its plain version; chip_smoke.py holds
the CUDA kernel against that plain version on the card.  Here the plain
version is held against the JAX package's formula
(pqt_tpu/models/query.py: `jnp.sum((vecs.astype(f32) - q[:, None]) ** 2,
-1)`) and against the Pallas `segmented_reduce` (kernel D, interpret mode)
over the squared differences.  Inputs are made with numpy from a seed.

Tolerances: integer-valued rows (uint8, or float32 holding integers) with
integer-valued queries at dim <= 128 give integer terms of at most 65025
whose sums stay below 2^24, so every order of addition gives the same
float32 and the results are equal to the bit; otherwise (fractional
queries or rows, dim 960) they agree within rtol 1e-5 (summation order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.models import query_big as JB
from pqt_tpu.ops.pallas import primitives as PP
import pqt_tpu_torch as T
from pqt_tpu_torch.models import query as TQ
from pqt_tpu_torch.models.db import PQTDatabase
from pqt_tpu_torch.ops import binning as TBIN
from pqt_tpu_torch.ops import distance as TDIST
from pqt_tpu_torch.ops.cuda import primitives as prim
from pqt_tpu_torch.ops.cuda.primitives import gather_sqdist
from test_torch_query import _assert_same_results, _carry_across, _sift_like

DTYPES = [np.uint8, np.float32]
DIMS = [128, 960, 24]


def _inputs(dtype, dim, b, k, integer, seed=0, n=300):
    """(tab (n, dim), pos (b, k) int32, q (b, dim) float32) from a seed:
    uint8 rows, or float32 rows in the same range (integer-valued for
    integer queries, fractional otherwise)."""
    rng = np.random.default_rng(seed + dim + 7 * b + k)
    tab = rng.integers(0, 256, (n, dim))
    if dtype == np.float32 and not integer:
        tab = tab + rng.uniform(-0.5, 0.5, (n, dim))
    q = rng.integers(0, 256, (b, dim)).astype(np.float64)
    if not integer:
        q += rng.uniform(-0.5, 0.5, (b, dim))
    pos = rng.integers(0, n, (b, k)).astype(np.int32)
    return tab.astype(dtype), pos, q.astype(np.float32)


def _exact(dim, integer):
    """Whether every order of addition gives the same float32 sum (integer
    rows and queries, every partial sum below 2^24)."""
    return integer and dim * 255 ** 2 < 2 ** 24


def _assert_matches(got, want, exact):
    assert got.dtype == np.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def _run(tab, pos, q):
    return gather_sqdist(torch.from_numpy(tab), torch.from_numpy(pos),
                         torch.from_numpy(q)).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("b,k", [(1, 1), (3, 77), (8, 256)])
@pytest.mark.parametrize("integer", [True, False],
                         ids=["int_queries", "float_queries"])
def test_gather_sqdist_matches_jax_formula(dtype, dim, b, k, integer):
    tab, pos, q = _inputs(dtype, dim, b, k, integer)
    jt = jnp.asarray(tab)
    want = np.asarray(jnp.sum((jt[jnp.asarray(pos)].astype(jnp.float32)
                               - jnp.asarray(q)[:, None]) ** 2, -1))
    _assert_matches(_run(tab, pos, q), want, _exact(dim, integer))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("b,k", [(3, 77), (8, 256)])
def test_gather_sqdist_matches_pallas_segmented_reduce(dtype, dim, b, k):
    """The old route on the TPU side: the squared differences of the
    gathered rows, summed by the Pallas segmented_reduce (parts 1)."""
    tab, pos, q = _inputs(dtype, dim, b, k, integer=True, seed=1)
    sq = (tab[pos].astype(np.float32) - q[:, None]) ** 2
    rows = b * k
    want = PP.segmented_reduce(jnp.asarray(sq.reshape(rows, dim)), 1,
                               rows_per_step=min(256, rows), interpret=True)
    _assert_matches(_run(tab, pos, q),
                    np.asarray(want).reshape(b, k), _exact(dim, True))


@pytest.mark.parametrize("case", ["last_row", "all_row_0", "no_candidates",
                                  "one_row_table"])
def test_gather_sqdist_edges(case):
    """Positions at row N - 1, every position 0, K = 0, and a table of one
    row: the plain version equals a loop over the rows."""
    tab, pos, q = _inputs(np.uint8, 128, 4, 33, integer=True, seed=2)
    if case == "last_row":
        pos[:, ::2] = tab.shape[0] - 1
    elif case == "all_row_0":
        pos[:] = 0
    elif case == "no_candidates":
        pos = pos[:, :0].copy()
    else:
        tab, pos = tab[:1].copy(), np.zeros_like(pos)
    got = _run(tab, pos, q)
    want = np.array([[((tab[p].astype(np.float64) - q[i]) ** 2).sum()
                      for p in row] for i, row in enumerate(pos)],
                    np.float32).reshape(pos.shape)
    np.testing.assert_array_equal(got, want)


def test_gather_sqdist_position_outside_the_table_raises():
    tab, pos, q = _inputs(np.uint8, 128, 2, 5, integer=True)
    pos[1, 3] = tab.shape[0]
    with pytest.raises(IndexError):
        _run(tab, pos, q)


def _refused(case):
    tab = torch.zeros((16, 8), dtype=torch.uint8)
    pos = torch.zeros((2, 4), dtype=torch.int32)
    q = torch.zeros((2, 8))
    return {
        "strided_table": (torch.zeros((8, 16), dtype=torch.uint8).T, pos, q),
        "int64_positions": (tab, pos.long(), q),
        "float16_table": (tab.half(), pos, q),
        "query_width": (tab, pos, torch.zeros((2, 9))),
        "query_batch": (tab, pos, torch.zeros((3, 8))),
        "float64_queries": (tab, pos, q.double()),
        "strided_positions": (tab, torch.zeros((4, 2), dtype=torch.int32).T,
                              q),
        "strided_queries": (tab, pos, torch.zeros((8, 2)).T),
        "1d_positions": (tab, pos[0], q),
        "1d_table": (tab[0], pos, q),
        "meta_tensors": (tab.to("meta"), pos.to("meta"), q.to("meta")),
    }[case]


@pytest.mark.parametrize("case", [
    "strided_table", "int64_positions", "float16_table", "query_width",
    "query_batch", "float64_queries", "strided_positions", "strided_queries",
    "1d_positions", "1d_table", "meta_tensors"])
def test_gather_sqdist_refuses_what_the_kernel_does_not_take(case):
    """Checked on the CPU too, so a CPU run catches a caller that the card
    would refuse; a tensor on neither the CPU nor a card is refused, not
    routed to the plain version."""
    with pytest.raises(ValueError):
        gather_sqdist(*_refused(case))


# ---------------------------------------------------------------------------
# routing: every exact entry point computes its distances with one call of
# gather_sqdist, and no raw-vector gather or parts=1 segment sum is left
# ---------------------------------------------------------------------------

ROUTE_CFG = T.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8,
                        hash_size=1 << 16, k1_build=4, k1_query=4,
                        max_bins=64, bin_enum_factor=4, max_candidates=256,
                        max_vec_per_bin=64, kmeans_iters=3, pair_top_m=16)


@pytest.fixture(scope="module")
def route_db(clustered_data):
    db_vecs, queries = clustered_data
    tree = T.train_tree(ROUTE_CFG, db_vecs[:1024], device="cpu")
    db = T.build_database(ROUTE_CFG, tree, db_vecs[:1024], device="cpu",
                          keep_vectors=True)
    csr_only = PQTDatabase(*db[:4], vectors=None, prefix2=db.prefix2,
                           vectors_csr=db.vectors[db.ids.long()])
    return tree, db, csr_only, torch.from_numpy(queries[:6])


ENTRY_POINTS = {
    "query_knn_exact_by_id": lambda c, t, db, csr, q: T.query_knn(
        c, t, db, q, 5, exact_rerank=True),
    "query_knn_exact_by_id_parts": lambda c, t, db, csr, q: T.query_knn(
        c.replace(pipeline="parts"), t, db, q, 5, exact_rerank=True),
    "query_core_exact_rows": lambda c, t, db, csr, q: T.query_knn(
        c, t, csr, q, 5, exact_rerank=True),
    "query_core_exact_slabs": lambda c, t, db, csr, q: T.query_knn(
        c.replace(gather_mode="slabs", slab_size=16), t, csr, q, 5,
        exact_rerank=True),
    "query_knn_refine_vectors": lambda c, t, db, csr, q: T.query_knn_refine(
        c, t, db, q, 5),
    "query_knn_refine_vectors_csr": lambda c, t, db, csr, q:
        T.query_knn_refine(c, t, csr, q, 5),
    "query_big_knn_perfect": lambda c, t, db, csr, q:
        T.query_big_knn_perfect(c, t, db, q, 5, 4, 32),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_exact_entry_points_route_through_gather_sqdist(route_db, entry,
                                                        monkeypatch):
    """query_big reaches gather_sqdist through query._row_sqdist, so one
    patch of the name in models/query.py counts every call."""
    tree, db, csr_only, q = route_db
    calls, parts, gathered = [], [], []

    def counting(tab, pos, qq):
        calls.append(tab)
        return gather_sqdist(tab, pos, qq)

    def reduce_recorder(x, n_parts, square=False):
        parts.append(n_parts)
        return prim.segmented_reduce(x, n_parts, square=square)

    def gather_recorder(fn):
        def wrapped(tab, *args, **kw):
            gathered.append(tab)
            return fn(tab, *args, **kw)
        return wrapped

    monkeypatch.setattr(TQ, "gather_sqdist", counting)
    monkeypatch.setattr(TDIST, "segmented_reduce", reduce_recorder)
    # query_big gathers no rows since the line re-rank reads them itself
    for mod in (TQ, TBIN):
        monkeypatch.setattr(mod, "gather_rows",
                            gather_recorder(mod.gather_rows))
    res = ENTRY_POINTS[entry](ROUTE_CFG, tree, db, csr_only, q)
    assert res.indices.shape == (6, 5) and (res.indices[:, 0] >= 0).all()
    raw = {db.vectors.data_ptr(), csr_only.vectors_csr.data_ptr()}
    assert len(calls) == 1 and calls[0].data_ptr() in raw
    assert parts and 1 not in parts
    assert not [t for t in gathered if t.data_ptr() in raw]


# ---------------------------------------------------------------------------
# the slice as a whole: uint8 SIFT-like vectors at dim 128 with integer
# queries, so the exact distances equal the JAX package's to the bit
# ---------------------------------------------------------------------------

SIFT_CFG = P.SIFT1M_CONFIG.replace(
    hash_size=1 << 16, max_bins=128, max_candidates=512, pair_top_m=64,
    enum_width=256, pair_filter=False)


@pytest.fixture(scope="module")
def sift(tmp_path_factory):
    rng = np.random.default_rng(5)
    data, queries = _sift_like(rng, 4096, 16)
    tree = P.train_tree(SIFT_CFG.replace(kmeans_iters=4), data)
    db = P.build_database(SIFT_CFG, tree, data, keep_vectors=True)
    return (SIFT_CFG, tree, db) + _carry_across(
        tmp_path_factory.mktemp("sift"), SIFT_CFG, tree, db), queries


@pytest.mark.parametrize("mode", ["exact", "refine", "big_perfect"])
def test_exact_distances_equal_jax_to_the_bit(sift, mode):
    (cfg, tree, db, tcfg, ttree, tdb), queries = sift
    assert tdb.vectors.dtype == torch.uint8
    q, tq = jnp.asarray(queries), torch.from_numpy(queries)
    if mode == "exact":
        want = P.query_knn(cfg, tree, db, q, 10, True)
        got = T.query_knn(tcfg, ttree, tdb, tq, 10, True)
    elif mode == "refine":
        want = P.query_knn_refine(cfg, tree, db, q, 10)
        got = T.query_knn_refine(tcfg, ttree, tdb, tq, 10)
    else:
        want = JB.query_big_knn_perfect(cfg, tree, db, q, 10, 8, 64)
        got = T.query_big_knn_perfect(tcfg, ttree, tdb, tq, 10, 8, 64)
    _assert_same_results(want, got)
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    assert np.isfinite(got.dists.numpy()[:, 0]).all()
