"""The port's multi-database engine against the JAX package's, on the CPU.

tests/test_multidb.py's CFG on `clustered_data`, over one tree that both
packages hold (trained by the port).  Given the same encoded vectors, the
groups' inverted files (prefix, counts, payload), pair_occ and the spill
files' bytes are equal to the bit.  The port's own build over that tree
differs only in t3's last bits (a float sum over line parts).  Queries over the JAX package's groups, in the three
rankings with the pair filter on and off: ids equal up to ties in distance,
distances within rtol 1e-5, atol 1e-4, candidate counts equal; the
occurrence ranking's ids equal to the bit, ties included.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pqt_tpu as P
from pqt_tpu.models import db as JDB
from pqt_tpu.models import multidb as JM
from pqt_tpu.models import tree as JT
from pqt_tpu.ops.distance import brute_force_knn
from pqt_tpu.utils import metrics
import pqt_tpu_torch as T
from pqt_tpu_torch.models import db as TDB
from pqt_tpu_torch.models import multidb as TM

CFG = P.PQTConfig(dim=32, p=4, c1=8, c2=4, line_parts=8, hash_size=1 << 16,
                  k1_build=4, k1_query=4, max_bins=256, max_candidates=1024,
                  max_vec_per_bin=256, kmeans_iters=10)
RTOL, ATOL = 1e-5, 1e-4


def _tcfg(cfg):
    return T.PQTConfig.from_json(cfg.to_json())


@pytest.fixture(scope="module")
def jax_built(clustered_data, tmp_path_factory):
    """One tree in both packages (trained by the port: the JAX package's
    training would add its ten-second compile to a module that tests no
    training), the JAX package's multi-database over it (kept vectors,
    pair_occ, and a spilled twin), and a port MultiDatabase made from the
    JAX groups."""
    db_vecs, queries = clustered_data
    ttree = T.train_tree(_tcfg(CFG), db_vecs, device="cpu")
    tree = JT.PQTree.from_codebooks(CFG, jnp.asarray(ttree.cb1.numpy()),
                                    jnp.asarray(ttree.cb2.numpy()))
    mdb = JM.build_multi_database(CFG, tree, db_vecs, group_parts=2,
                                  encode_chunk=2048, keep_vectors=True)
    spill = str(tmp_path_factory.mktemp("mspill") / "jax")
    JM.build_multi_database(CFG, tree, db_vecs, group_parts=2,
                            encode_chunk=2048, spill_path=spill)
    tmdb = TM.MultiDatabase.from_numpy(
        [(np.asarray(d.prefix), np.asarray(d.counts), np.asarray(d.payload))
         for d in mdb.databases],
        vectors=np.asarray(mdb.vectors), pair_occ=np.asarray(mdb.pair_occ),
        device="cpu")
    _, gt = brute_force_knn(jnp.asarray(queries), jnp.asarray(db_vecs), 10)
    return dict(tree=tree, mdb=mdb, spill=spill, ttree=ttree, tmdb=tmdb,
                gt=np.asarray(gt))


def _jax_encodings(tree, data):
    """The JAX package's part codes and payload rows in id order."""
    x = jnp.asarray(data)
    codes, t3 = JDB.encode_line_codes(CFG, tree, x)
    packed = JDB.pack_payload_cfg(CFG, np.arange(len(data), dtype=np.int32),
                                  np.asarray(codes), np.asarray(t3))
    return np.asarray(JDB.encode_part_codes(CFG, tree, x)), packed


def _assert_groups_equal(got, want, t3_bits=True):
    for g, w in zip(got, want):
        for leaf in ("prefix", "counts", "prefix2"):
            np.testing.assert_array_equal(np.asarray(getattr(g, leaf)),
                                          np.asarray(getattr(w, leaf)))
        gp, wp = np.asarray(g.payload), np.asarray(w.payload)
        if t3_bits:
            np.testing.assert_array_equal(gp, wp)
            continue
        np.testing.assert_array_equal(gp[:, [0] + list(range(2, gp.shape[1]))],
                                      wp[:, [0] + list(range(2, wp.shape[1]))])
        # t3 sums terms of both signs: bound the error by their scale, as
        # tests/test_torch_build.py does
        t3_g, t3_w = gp[:, 1].view(np.float32), wp[:, 1].view(np.float32)
        np.testing.assert_allclose(t3_g, t3_w, rtol=1e-4,
                                   atol=1e-6 * np.abs(t3_w).max())


@pytest.mark.parametrize("spill", [False, True], ids=["ram", "spill"])
def test_groups_from_jax_encodings_are_bit_equal(jax_built, clustered_data,
                                                 tmp_path, spill):
    """assemble_multi_database over the JAX package's encodings gives its
    prefix, counts, payload and pair_occ; spilled, the same bytes in
    `<spill_path>.g<i>` memmaps."""
    db_vecs, _ = clustered_data
    codes, packed = _jax_encodings(jax_built["tree"], db_vecs)
    path = str(tmp_path / "port") if spill else None
    dbs, occ = TM.assemble_multi_database(_tcfg(CFG), codes, packed, 2,
                                          spill_path=path, device="cpu")
    _assert_groups_equal(dbs, jax_built["mdb"].databases)
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(jax_built["mdb"].pair_occ))
    if spill:
        for gi, db in enumerate(dbs):
            assert isinstance(db.payload, np.memmap)
            with open(f"{path}.g{gi}", "rb") as a, \
                    open(f"{jax_built['spill']}.g{gi}", "rb") as b:
                assert a.read() == b.read()


def test_build_over_jax_tree_matches(jax_built, clustered_data):
    """The port's whole build over the tree the JAX package built with:
    layout, ids, codes and pair_occ to the bit, t3 to its float rounding;
    vectors kept raw."""
    db_vecs, _ = clustered_data
    got = TM.build_multi_database(_tcfg(CFG), jax_built["ttree"], db_vecs, 2,
                                  encode_chunk=1500, keep_vectors=True,
                                  device="cpu")
    want = jax_built["mdb"]
    assert got.n_groups == 2
    _assert_groups_equal(got.databases, want.databases, t3_bits=False)
    np.testing.assert_array_equal(got.pair_occ.numpy(),
                                  np.asarray(want.pair_occ))
    np.testing.assert_array_equal(got.vectors.numpy(), db_vecs)


def _assert_same_results(want, got):
    wid, wd = np.asarray(want.indices), np.asarray(want.dists)
    gid, gd = got.indices.numpy(), got.dists.numpy()
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    for b, s in zip(*np.nonzero(gid != wid)):
        tie = np.isclose(wd[b], wd[b, s], rtol=RTOL, atol=ATOL)
        assert tie.sum() > 1 or s == wd.shape[1] - 1, (b, s)


QUERY_CASES = {
    "occurrence": (dict(multidb_rank="occurrence"), 10, False),
    "distance": (dict(multidb_rank="distance"), 10, False),
    "exact": (dict(), 10, True),
    # k above the 64 candidates: the tail is -1 / +inf
    "occurrence_k_over": (dict(max_candidates=64), 80, False),
    "exact_k_over": (dict(max_candidates=64), 80, True),
}


@pytest.mark.parametrize("pair_filter", [True, False],
                         ids=["filter", "nofilter"])
@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_multi_matches_jax(jax_built, clustered_data, case,
                                 pair_filter):
    _, queries = clustered_data
    kw, k, exact = QUERY_CASES[case]
    cfg = CFG.replace(pair_filter=pair_filter, **kw)
    want = JM.query_multi_knn(cfg, jax_built["tree"], jax_built["mdb"],
                              jnp.asarray(queries), k, exact)
    got = TM.query_multi_knn(_tcfg(cfg), jax_built["ttree"],
                             jax_built["tmdb"], torch.from_numpy(queries), k,
                             exact)
    assert got.indices.shape == (len(queries), k)
    _assert_same_results(want, got)
    if cfg.multidb_rank == "occurrence" and not exact:
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
    if k > cfg.max_candidates:
        assert (got.indices.numpy()[:, cfg.max_candidates:] == -1).all()
        assert np.isinf(got.dists.numpy()[:, cfg.max_candidates:]).all()
    for row in got.indices.numpy():
        real = row[row >= 0]
        assert len(real) == len(np.unique(real))
    if k == 10:
        r = metrics.recall_at(got.indices.numpy(), jax_built["gt"])
        assert r == metrics.recall_at(np.asarray(want.indices),
                                      jax_built["gt"])


def _jax_occurrence_order(dists, occ, ids):
    """The JAX package's occurrence ranking (models/multidb.py): a stable
    sort on (not finite, -occurrences, distance)."""
    finite = jnp.isfinite(dists)
    key0 = (~finite).astype(jnp.int32)
    key1 = jnp.where(finite, -occ, 0)
    _, _, d_s, ids_s = jax.lax.sort((key0, key1, dists, ids), dimension=-1,
                                    num_keys=3)
    return np.asarray(ids_s), np.asarray(d_s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occurrence_ranking_is_bit_equal_on_ties(seed):
    """Distances drawn from a handful of values, occurrences from 1-2 and a
    third of the slots +inf: every kind of tie, each ranked as the JAX
    package's stable three-key sort ranks it."""
    rng = np.random.default_rng(seed)
    B, K = 16, 300
    dists = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), (B, K))
    dists[rng.random((B, K)) < 0.3] = np.inf
    occ = rng.integers(1, 3, (B, K)).astype(np.int32)
    ids = rng.permutation(B * K).reshape(B, K).astype(np.int32)
    want_ids, want_d = _jax_occurrence_order(jnp.asarray(dists),
                                             jnp.asarray(occ),
                                             jnp.asarray(ids))
    for k in (K, 37):
        got_ids, got_d = TM._occurrence_top(torch.from_numpy(dists),
                                            torch.from_numpy(occ),
                                            torch.from_numpy(ids), k)
        want_k = np.where(np.isfinite(want_d[:, :k]), want_ids[:, :k], -1)
        np.testing.assert_array_equal(got_ids.numpy(), want_k)
        np.testing.assert_array_equal(got_d.numpy(), want_d[:, :k])


def test_spilled_database_is_placed_once(jax_built, clustered_data,
                                         tmp_path):
    """A spilled build keeps its payloads on the host: a query refuses
    them until place_multi_database uploads them, once; serving then moves
    no more host bytes, and the ids equal the in-memory build's."""
    db_vecs, queries = clustered_data
    tcfg, ttree = _tcfg(CFG), jax_built["ttree"]
    ram = TM.build_multi_database(tcfg, ttree, db_vecs, 2, keep_vectors=True,
                                  device="cpu")
    spilled = TM.build_multi_database(tcfg, ttree, db_vecs, 2,
                                      keep_vectors=True,
                                      spill_path=str(tmp_path / "s"),
                                      device="cpu")
    assert all(isinstance(d.payload, np.memmap) for d in spilled.databases)
    q = torch.from_numpy(queries)
    with pytest.raises(ValueError, match="place_multi_database"):
        TM.query_multi_knn(tcfg, ttree, spilled, q, 10)
    before = TDB.to_device.bytes_copied
    placed = TM.place_multi_database(spilled, device="cpu")
    payload_bytes = sum(d.payload.nbytes for d in spilled.databases)
    assert TDB.to_device.bytes_copied - before == payload_bytes
    before = TDB.to_device.bytes_copied
    for exact in (False, True):
        for s in (0, 32):
            got = TM.query_multi_knn(tcfg, ttree, placed, q[s:s + 32], 10,
                                     exact)
            want = TM.query_multi_knn(tcfg, ttree, ram, q[s:s + 32], 10,
                                      exact)
            assert torch.equal(got.indices, want.indices)
            assert torch.equal(got.dists, want.dists)
    assert TDB.to_device.bytes_copied == before


def test_multi_exact_recall_and_guards(jax_built, clustered_data):
    """Exact re-rank of the union reaches tests/test_multidb.py's floor and
    beats the line ranking; without kept vectors it is refused."""
    _, queries = clustered_data
    tcfg, ttree, tmdb = _tcfg(CFG), jax_built["ttree"], jax_built["tmdb"]
    q = torch.from_numpy(queries)
    line = TM.query_multi_knn(tcfg, ttree, tmdb, q, 10)
    exact = TM.query_multi_knn(tcfg, ttree, tmdb, q, 10, True)
    r_line = metrics.recall_at(line.indices.numpy(), jax_built["gt"])["R@1"]
    r_exact = metrics.recall_at(exact.indices.numpy(), jax_built["gt"])["R@1"]
    assert r_exact >= max(r_line, 0.6), (r_exact, r_line)
    with pytest.raises(ValueError, match="keep_vectors"):
        TM.query_multi_knn(tcfg, ttree, tmdb._replace(vectors=None), q, 10,
                           True)
    with pytest.raises(ValueError, match="divide"):
        TM.build_multi_database(tcfg, ttree, np.zeros((8, 32), np.float32),
                                3, device="cpu")


def test_multidb_entry_points_refuse_missing_card(monkeypatch, jax_built,
                                                  clustered_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db_vecs, _ = clustered_data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.build_multi_database(_tcfg(CFG), jax_built["ttree"], db_vecs, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.place_multi_database(jax_built["tmdb"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.MultiDatabase.from_numpy([], pair_occ=np.zeros((2, 4), np.uint8))
