"""The port's parts pipeline (pipeline="parts"), pair filter and slab
gathers against the JAX package's, stage by stage and end to end, on
artifacts that the JAX package built and saved and the port loaded.

Settings: the small PAIR_CFG of tests/test_torch_query.py on the parts
pipeline with exact and hashed bin ids, and the bench-shaped config (SIFT1M
width, 512 bins / 1024 candidates) with the pair filter on.  Given the same
distance tables, sorted part codes, bins, counts, candidate positions and
ids are equal to the bit, with and without the filter and in rows and slab
mode; distances agree within 1e-5 relative, and result ids may differ only
inside a run of equal distances.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.models import query as JQ
from pqt_tpu.ops import binning as JB
from pqt_tpu.ops.distance import brute_force_knn
from pqt_tpu.utils.metrics import candidate_recall, recall_at
import pqt_tpu_torch as T
from pqt_tpu_torch.models import query as TQ
from pqt_tpu_torch.ops import binning as TB
from test_torch_query import (BENCH_CFG, HASHED_CFG, PAIR_CFG,
                              _assert_same_results, _carry_across,
                              _sampled_tree, _sift_like)

PARTS = {"exact": PAIR_CFG.replace(pipeline="parts"),
         "hashed": HASHED_CFG.replace(pipeline="parts"),
         "bench": BENCH_CFG.replace(pipeline="parts", pair_filter=True)}
SETTINGS = list(PARTS)


@pytest.fixture(scope="module")
def built(clustered_data, tmp_path_factory):
    """{name: ((jax cfg, tree, db, port cfg, tree, db), db vectors,
    queries)}; every database is built with the pair filter on, so it
    carries pair_occ."""
    db_vecs, queries = clustered_data
    tree = P.train_tree(PARTS["exact"], db_vecs)
    out = {}
    for name in ("exact", "hashed"):
        cfg = PARTS[name]
        db = P.build_database(cfg, tree, db_vecs, encode_chunk=2048,
                              keep_vectors=True)
        out[name] = ((cfg, tree, db) + _carry_across(
            tmp_path_factory.mktemp(name), cfg, tree, db), db_vecs, queries)
    rng = np.random.default_rng(0)
    data, bq = _sift_like(rng, 16384, 48)
    cfg = PARTS["bench"]
    btree = _sampled_tree(cfg, data, rng)
    db = P.build_database(cfg, btree, data, encode_chunk=8192,
                          keep_vectors=True)
    out["bench"] = ((cfg, btree, db) + _carry_across(
        tmp_path_factory.mktemp("bench"), cfg, btree, db), data, bq)
    return out


def _variant(setting, **kw):
    """The setting with `kw` replaced in both packages' configs."""
    (cfg, tree, db, tcfg, ttree, tdb), vecs, queries = setting
    return ((cfg.replace(**kw), tree, db, tcfg.replace(**kw), ttree, tdb),
            vecs, queries)


def _nonempty_equal(got_bins, got_cnt, want_bins, want_cnt):
    """Counts equal everywhere; bins equal where the count is > 0."""
    want_bins, want_cnt = np.asarray(want_bins), np.asarray(want_cnt)
    np.testing.assert_array_equal(got_cnt.numpy(), want_cnt)
    live = want_cnt > 0
    assert live.any()
    np.testing.assert_array_equal(got_bins.numpy()[live], want_bins[live])


@pytest.mark.parametrize("name", SETTINGS)
@pytest.mark.parametrize("pair_filter", [True, False])
def test_enumeration_equal(built, name, pair_filter):
    (cfg, tree, db, tcfg, ttree, tdb), _, queries = _variant(
        built[name], pair_filter=pair_filter)
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    sd2, scodes = JQ._sorted_part_lists(cfg, tree, q)
    tsd2, tscodes = TQ._sorted_part_lists(tcfg, ttree, tq)
    np.testing.assert_array_equal(tscodes.numpy(), np.asarray(scodes))
    np.testing.assert_allclose(tsd2.numpy(), np.asarray(sd2), rtol=1e-5)
    bins, cnt = JQ._enumerate_bins(cfg, sd2, scodes, db.counts,
                                   pair_occ=db.pair_occ)
    tbins, tcnt = TQ._enumerate_bins(tcfg, tsd2, tscodes, tdb.counts,
                                     pair_occ=tdb.pair_occ)
    assert tbins.dtype == torch.int32
    _nonempty_equal(tbins, tcnt, bins, cnt)
    # the JAX package's sorts on the CPU keep ties in order, so the empty
    # slots past the last non-empty bin agree too
    np.testing.assert_array_equal(tbins.numpy(), np.asarray(bins))


@pytest.mark.parametrize("name", SETTINGS)
@pytest.mark.parametrize("gather_mode", ["rows", "slabs"])
@pytest.mark.parametrize("pair_filter", [True, False])
def test_core_candidates_equal(built, name, gather_mode, pair_filter):
    (cfg, tree, db, tcfg, ttree, tdb), _, queries = _variant(
        built[name], gather_mode=gather_mode, slab_size=32,
        pair_filter=pair_filter)
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    core = jax.jit(functools.partial(JQ.query_core, cfg, k=0,
                                     want_candidates=True))
    ids, line_d, n_cand, pos = core(tree, db.prefix, db.counts, db.payload,
                                    q, pair_occ=db.pair_occ)
    tids, tline_d, tn_cand, tpos = TQ.query_core(
        tcfg, ttree, tdb.prefix, tdb.counts, tdb.payload, tq, 0,
        pair_occ=tdb.pair_occ, want_candidates=True)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tn_cand.numpy(), np.asarray(n_cand))
    assert (np.asarray(n_cand) > 0).all()
    np.testing.assert_allclose(tline_d.numpy(), np.asarray(line_d),
                               rtol=1e-5)


@pytest.mark.parametrize("name", SETTINGS)
@pytest.mark.parametrize("mode", ["exact", "line", "refine", "slabs_exact",
                                  "slabs_line"])
def test_query_results_equal(built, name, mode):
    setting = built[name]
    if mode.startswith("slabs"):
        setting = _variant(setting, gather_mode="slabs", slab_size=32)
    (cfg, tree, db, tcfg, ttree, tdb), db_vecs, queries = setting
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    if mode == "refine":
        want = P.query_knn_refine(cfg, tree, db, q, 10)
        got = T.query_knn_refine(tcfg, ttree, tdb, tq, 10)
    else:
        exact = mode.endswith("exact")
        want = P.query_knn(cfg, tree, db, q, 10, exact)
        got = T.query_knn(tcfg, ttree, tdb, tq, 10, exact)
    assert got.indices.dtype == torch.int32
    _assert_same_results(want, got)
    _, gt = brute_force_knn(q, jnp.asarray(db_vecs, jnp.float32), 10)
    gt = np.asarray(gt)
    assert (recall_at(got.indices.numpy(), gt)
            == recall_at(np.asarray(want.indices), gt))


@pytest.mark.parametrize("name", SETTINGS)
def test_candidates_equal(built, name):
    (cfg, tree, db, tcfg, ttree, tdb), db_vecs, queries = built[name]
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    ids, valid = JQ.query_candidates(cfg, tree, db, q)
    tids, tvalid = T.query_candidates(tcfg, ttree, tdb, tq)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    _, gt = brute_force_knn(q, jnp.asarray(db_vecs, jnp.float32), 1)
    assert (candidate_recall(tids.numpy(), tvalid.numpy(), np.asarray(gt))
            == candidate_recall(np.asarray(ids), np.asarray(valid),
                                np.asarray(gt)))


def test_pair_pipeline_in_slab_mode_equal(built):
    """Slab gathers serve the pair pipeline too (its exact re-rank reads
    the slab candidates)."""
    (cfg, tree, db, tcfg, ttree, tdb), _, queries = _variant(
        built["exact"], pipeline="pair", gather_mode="slabs", slab_size=16)
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    for exact in (False, True):
        _assert_same_results(P.query_knn(cfg, tree, db, q, 10, exact),
                             T.query_knn(tcfg, ttree, tdb, tq, 10, exact))


@pytest.mark.parametrize("S,cap", [(8, 64), (32, 7), (1, 5)])
def test_gather_slabs_equal(S, cap):
    rng = np.random.default_rng(S + cap)
    counts = rng.integers(0, 40, (16, 64)).astype(np.int32)
    counts[counts < 10] = 0
    counts[5] = 0                                   # no candidates at all
    prefix = rng.integers(0, 10_000, (16, 64)).astype(np.int32)
    n_slabs = 37
    ws, wv = jax.jit(JB.gather_slabs, static_argnums=(2, 3, 4))(
        jnp.asarray(prefix), jnp.asarray(counts), n_slabs, S, cap)
    gs, gv = TB.gather_slabs(torch.from_numpy(prefix),
                             torch.from_numpy(counts), n_slabs, S, cap)
    assert gs.dtype == gv.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("N,S", [(20, 8), (5, 8), (1000, 32)])
def test_fetch_slab_rows_equal(N, S):
    """Including windows that run past the payload's end (shifted left, as
    tests/test_slabs.py checks for the JAX package) and a payload shorter
    than a slab."""
    rng = np.random.default_rng(N + S)
    payload = rng.integers(0, 1 << 30, (N, 3)).astype(np.int32)
    starts = rng.integers(0, N, (4, 6)).astype(np.int32)
    starts[0, 0] = N - 1
    valid_cnt = rng.integers(0, S + 1, (4, 6)).astype(np.int32)
    valid_cnt = np.minimum(valid_cnt, N - starts)
    wr, wv = JB.fetch_slab_rows(jnp.asarray(payload), jnp.asarray(starts),
                                jnp.asarray(valid_cnt), S)
    gr, gv = TB.fetch_slab_rows(torch.from_numpy(payload),
                                torch.from_numpy(starts),
                                torch.from_numpy(valid_cnt), S)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    got = gr.numpy()[0][gv.numpy()[0]]
    assert got.shape[0] == valid_cnt[0].sum()
