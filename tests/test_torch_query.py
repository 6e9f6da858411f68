"""The port's pair-pipeline query against the JAX package's, stage by stage
and end to end, on artifacts that the JAX package built and saved and the
port loaded (`save_tree`/`save_database` -> `load_tree`/`load_database`).

Two settings: the small PAIR_CFG/HASHED_CFG of tests/test_pair_pipeline.py
on `clustered_data` (exact and hashed bin ids), and a bench-shaped config
(SIFT1M width, 512 bins / 1024 candidates, pair_top_m 128, uint8 SIFT-like
vectors) whose tree comes from codebooks sampled from the data with numpy.
Given the same distance tables, bin ids, probe extents and candidate ids are
equal to the bit; distances agree within 1e-5 relative, and result ids may
differ only inside a run of equal distances.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.io import artifacts as JA
from pqt_tpu.models import query as JQ
from pqt_tpu.ops.distance import brute_force_knn
from pqt_tpu.utils.metrics import candidate_recall, recall_at
import pqt_tpu_torch as T
from pqt_tpu_torch.io import artifacts as TA
from pqt_tpu_torch.models import query as TQ

PAIR_CFG = P.PQTConfig(
    dim=32, p=4, c1=4, c2=4, line_parts=8, hash_size=1 << 16,
    k1_build=4, k1_query=4, max_bins=256, max_candidates=1024,
    max_vec_per_bin=256, kmeans_iters=10, pair_top_m=64)
HASHED_CFG = PAIR_CFG.replace(hash_size=1 << 10)
BENCH_CFG = P.SIFT1M_CONFIG.replace(
    hash_size=1 << 16, max_bins=512, max_candidates=1024, pair_top_m=128,
    enum_width=512, pair_filter=False)


def _carry_across(tmp, cfg, tree, db):
    """Save with the JAX package, load with the port (on the CPU)."""
    JA.save_tree(str(tmp / "tree"), cfg, tree)
    JA.save_database(str(tmp / "db"), cfg, db)
    tcfg = T.PQTConfig.from_json(cfg.to_json())
    return (tcfg, TA.load_tree(str(tmp / "tree"), tcfg, device="cpu"),
            TA.load_database(str(tmp / "db"), tcfg, device="cpu"))


def _sift_like(rng, n, n_queries, dim=128, n_coarse=64, subs=16):
    """bench.py's two-level cluster model, scaled down."""
    centers = rng.uniform(0, 140, (n_coarse, dim))
    sub = np.repeat(centers, subs, axis=0) + rng.normal(
        0, 15.0, (n_coarse * subs, dim))
    data = sub[rng.integers(0, len(sub), n)] + rng.normal(0, 5.0, (n, dim))
    qs = sub[rng.integers(0, len(sub), n_queries)] + rng.normal(
        0, 5.0, (n_queries, dim))
    return (np.clip(np.round(data), 0, 255).astype(np.uint8),
            np.clip(np.round(qs), 0, 255).astype(np.float32))


def _sampled_tree(cfg, data, rng):
    """Codebooks sampled from data rows: cb1 from random rows, cb2 from rows
    of each L1 cell's population (per part)."""
    x = data.astype(np.float32).reshape(len(data), cfg.p, cfg.vl)
    cb1 = x[rng.choice(len(x), cfg.c1, replace=False)].transpose(1, 0, 2)
    cb2 = np.empty((cfg.p, cfg.c1, cfg.c2, cfg.vl), np.float32)
    for j in range(cfg.p):
        d = ((x[:, j, None, :] - cb1[j][None]) ** 2).sum(-1)
        cell = d.argmin(1)
        for c in range(cfg.c1):
            pop = np.nonzero(cell == c)[0]
            pick = rng.choice(pop, cfg.c2, replace=len(pop) < cfg.c2)
            cb2[j, c] = x[pick, j]
    return P.PQTree.from_codebooks(cfg, jnp.asarray(cb1), jnp.asarray(cb2))


@pytest.fixture(scope="module")
def small(clustered_data, tmp_path_factory):
    """{name: (jax cfg, tree, db, port cfg, tree, db)} for exact and hashed
    bin ids; one JAX-trained tree."""
    db_vecs, queries = clustered_data
    tree = P.train_tree(PAIR_CFG, db_vecs)
    out = {}
    for name, cfg in (("exact", PAIR_CFG), ("hashed", HASHED_CFG)):
        db = P.build_database(cfg, tree, db_vecs, encode_chunk=2048,
                              keep_vectors=True)
        out[name] = (cfg, tree, db) + _carry_across(
            tmp_path_factory.mktemp(name), cfg, tree, db)
    return out, db_vecs, queries


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    rng = np.random.default_rng(0)
    data, queries = _sift_like(rng, 16384, 48)
    tree = _sampled_tree(BENCH_CFG, data, rng)
    db = P.build_database(BENCH_CFG, tree, data, encode_chunk=8192,
                          keep_vectors=True)
    return ((BENCH_CFG, tree, db) + _carry_across(
        tmp_path_factory.mktemp("bench"), BENCH_CFG, tree, db), data, queries)


def _setting(small, bench, name):
    if name == "bench":
        return bench
    sets, db_vecs, queries = small
    return sets[name], db_vecs, queries


@functools.lru_cache(maxsize=None)
def _jax_core_pair(cfg):
    return jax.jit(functools.partial(JQ.query_core_pair, cfg, k=0,
                                     want_candidates=True))


SETTINGS = ["exact", "hashed", "bench"]


@pytest.mark.parametrize("name", SETTINGS)
def test_stages_equal(small, bench, name):
    (cfg, tree, db, tcfg, ttree, tdb), _, queries = _setting(
        small, bench, name)
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    d, h, exact = JQ._pair_stage(cfg, tree, q, db.pair_occ)
    td, th, texact = TQ._pair_stage(tcfg, ttree, tq, tdb.pair_occ)
    assert texact == exact == (name == "exact")
    np.testing.assert_allclose(td.numpy(), np.asarray(d), rtol=1e-5)
    np.testing.assert_array_equal(th.numpy(), np.asarray(h).astype(np.int64))

    bins = JQ._enumerate_bins_pair(cfg, h, exact)
    tbins = TQ._enumerate_bins_pair(tcfg, th, texact)
    np.testing.assert_array_equal(tbins.numpy(), np.asarray(bins))

    start, cnt = JQ._probe_bins(cfg, bins, db.prefix2)
    tstart, tcnt = TQ._probe_bins(tcfg, tbins, tdb.prefix2)
    np.testing.assert_array_equal(tstart.numpy(), np.asarray(start))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
    assert (np.asarray(cnt) > 0).any()

    ids, line_d, n_cand, pos = _jax_core_pair(cfg)(
        tree, db.prefix2, db.payload, q, pair_occ=db.pair_occ)
    tids, tline_d, tn_cand, tpos = TQ.query_core_pair(
        tcfg, ttree, tdb.prefix2, tdb.payload, tq, 0, pair_occ=tdb.pair_occ,
        want_candidates=True)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(tn_cand.numpy(), np.asarray(n_cand))
    np.testing.assert_allclose(tline_d.numpy(), np.asarray(line_d),
                               rtol=1e-5)


def _assert_same_results(want, got, rtol=1e-5):
    wid, wd = np.asarray(want.indices), np.asarray(want.dists)
    gid, gd = got.indices.numpy(), got.dists.numpy()
    np.testing.assert_allclose(gd, wd, rtol=rtol)
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    for b, s in zip(*np.nonzero(gid != wid)):
        tie = np.isclose(wd[b], wd[b, s], rtol=rtol)
        assert tie.sum() > 1 or s == wd.shape[1] - 1, (b, s)


@pytest.mark.parametrize("name", SETTINGS)
@pytest.mark.parametrize("mode", ["exact", "line", "refine"])
def test_query_results_equal(small, bench, name, mode):
    (cfg, tree, db, tcfg, ttree, tdb), db_vecs, queries = _setting(
        small, bench, name)
    q = jnp.asarray(queries)
    tq = torch.from_numpy(queries)
    if mode == "refine":
        want = P.query_knn_refine(cfg, tree, db, q, 10)
        got = T.query_knn_refine(tcfg, ttree, tdb, tq, 10)
    else:
        want = P.query_knn(cfg, tree, db, q, 10, mode == "exact")
        got = T.query_knn(tcfg, ttree, tdb, tq, 10, mode == "exact")
    assert got.indices.dtype == torch.int32
    _assert_same_results(want, got)
    _, gt = brute_force_knn(q, jnp.asarray(db_vecs, jnp.float32), 10)
    gt = np.asarray(gt)
    assert (recall_at(got.indices.numpy(), gt)
            == recall_at(np.asarray(want.indices), gt))


@pytest.mark.parametrize("name", ["exact", "bench"])
def test_candidates_and_k_padding(small, bench, name):
    (cfg, tree, db, tcfg, ttree, tdb), db_vecs, queries = _setting(
        small, bench, name)
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
    # more results than candidates: padded with -1 / +inf, as in JAX
    k = cfg.max_candidates + 5
    want = P.query_knn(cfg, tree, db, q[:4], k)
    got = T.query_knn(tcfg, ttree, tdb, tq[:4], k)
    assert got.indices.shape == (4, k)
    _assert_same_results(want, got)
